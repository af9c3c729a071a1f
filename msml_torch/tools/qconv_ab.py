"""Time `quant_act` against another build of its CUDA source, at every
distinct int8 geometry of arc18_msml's quantized eval forward, on the card,
beside `qconv_int8`, the bounds and cuDNN.

    python -m msml_torch.tools.qconv_ab --base <dir>/qconv_int8.cu \\
        [--out FILE.json] [--markdown FILE.md]

`--base` is a `csrc/qconv_int8.cu` with the plain C entry point of
`quant_act`'s first design, `quant_act(x, xq, sx, amax, n, c, hw, cp, bf16,
stream)` with `amax` an (n,) workspace it zeroes (for instance a parent
commit's, unpacked with `git archive` into a gitignored directory). Both
are built with `kernels/_nvcc.py`'s flags. The geometries are those of
`configs/arc18_msml.yaml` (random weights from seed 0, bf16, quantized by
`core/quantize.quantize_eval_model`), each at B = 512 on random inputs.
Per geometry, in turns base, current, current, base: `quant_act`'s device
time of one call from CUDA graphs of the calls on two inputs (the median
of 3 replays; the smaller of each build's two turns), both builds' codes
and scales bit for bit equal. Beside them: `quant_act`'s bound (its bytes
at 3.35 TB/s, `kernels/qconv.py::site_work`) and plan (`quant_act_plan`),
then `qconv_int8`'s time, bound (the larger of the bytes at 3.35 TB/s and
the real int8 operations at 1,979 TOPS) and plan, and cuDNN's bf16 op of
the same shape (`F.conv2d`, `F.conv_transpose2d`, `F.linear` on random
weights: the yardstick, not a path of the port). Prints one line per
geometry and the sums weighted by each geometry's number of sites;
`--out` writes the rows as JSON and `--markdown` the table of
`docs/int8_sites_h100.md`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch

from msml_torch.kernels import _nvcc, qconv

BATCH, SEED = 512, 0       # the quantized eval forward's batch; weights
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate
INT8_OPS = 1979e12         # its dense int8 tensor-core peak (operations / s)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "arc18_msml.yaml")


def base_act(lib, x, cp):
    """The base build's quant_act (the first design) on x -> (xq, sx)."""
    x4 = x if x.dim() == 4 else x[:, :, None, None]
    n, c, h, w = x4.shape
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    sx = torch.empty((n,), dtype=torch.float32, device=x.device)
    amax = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = lib.quant_act(x4.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                        amax.data_ptr(), n, c, h * w, cp,
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "base quant_act")
    return xq, sx


def graph_ms(fns, replays: int = 3) -> float:
    """Device ms per call of `fns`, captured once in a CUDA graph: the
    median over `replays` replays, by CUDA events."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    del graph
    return statistics.median(times)


def arc18_int8(device: str, seed: int):
    """arc18_msml (configs/arc18_msml.yaml, random weights from the seed,
    bf16) and its int8 copy (`core/quantize.quantize_eval_model`)."""
    from msml_torch.core.config import config_init, load_yaml
    from msml_torch.core.quantize import quantize_eval_model
    from msml_torch.nn.msml import msml_from_config

    cfg = config_init(load_yaml(CONFIG), make_output_dir=False)
    model = msml_from_config(cfg, device=device, seed=seed)
    return model, quantize_eval_model(model, (112, 112, 3))


def int8_sites_of(qmodel, x) -> dict:
    """The int8 sites that qmodel's forward on x reaches, grouped by their
    geometry: {(kind, input shape less the batch, qconv geometry, dtype,
    bias, output channels): [(name, module, the site's input), ...]}."""
    from msml_torch.core.quantize import QuantConv

    sites, handles = {}, []
    for name, m in qmodel.named_modules():
        if not isinstance(m, QuantConv):
            continue

        def hook(mod, args, name=name):
            xin = args[0]
            hw = (1, 1) if xin.dim() == 2 else tuple(xin.shape[2:])
            key = (mod.kind, tuple(xin.shape[1:]), tuple(mod.geometry(*hw)),
                   mod.dtype, mod.bias is not None, mod.sw.shape[0])
            sites.setdefault(key, []).append((name, mod, xin))
        handles.append(m.register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            qmodel(x)
    finally:
        for h in handles:
            h.remove()
    return sites


def cudnn_call(m, x, generator):
    """The float op of the int8 site m as one bf16 cuDNN / cuBLAS call on x
    (random weights of its shape): the yardstick, not used by the port."""
    import torch.nn.functional as F

    co = m.sw.shape[0]
    kh, kw = m.kernel
    if m.kind == "linear":
        w = torch.randn((co, x.shape[1]), generator=generator, device="cuda",
                        dtype=x.dtype)
        return lambda: F.linear(x, w)
    ci = x.shape[1]
    if m.kind == "transposed":
        w = torch.randn((ci, co, kh, kw), generator=generator, device="cuda",
                        dtype=x.dtype)
        return lambda: F.conv_transpose2d(
            x, w, stride=m.dil, padding=(kh - 1 - m.pad[0], kw - 1 - m.pad[1]))
    w = torch.randn((co, ci, kh, kw), generator=generator, device="cuda",
                    dtype=x.dtype)
    return lambda: F.conv2d(x, w, stride=m.stride, padding=m.pad)


def markdown(rows: list, total: dict, smi: str, batch: int) -> str:
    """The per-geometry table of docs/int8_sites_h100.md."""
    def dims(shape):
        return "×".join(map(str, shape))

    lines = [
        "| Site (×sites) | Kind | Input | Out | Kernel | quant_act v1 | v2 "
        "| bound | v2 plan | qconv_int8 | bound | by | plan | cuDNN bf16 |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        kh, kw, sh, _, _, _, dh = r["geometry"][:7]
        kernel = f"{kh}×{kw}" + (f" s{sh}" if sh > 1 else "") + (
            f" lhs-dil {dh}" if dh > 1 else "")
        lines.append(
            f"| `{r['site']}` (×{r['sites']}) | {r['kind']} | "
            f"{dims(r['input'])} | {r['out_channels']} | {kernel} | "
            f"{r['act_base_ms']:.4f} | {r['act_ms']:.4f} | "
            f"{r['act_bound_ms']:.4f} | {r['act_plan']} | "
            f"{r['qconv_ms']:.4f} | {r['qconv_bound_ms']:.4f} | "
            f"{r['bound_by']} | {r['plan']} | {r['cudnn_bf16_ms']:.4f} |")
    lines.append("")
    lines.append(
        f"Summed over all {sum(r['sites'] for r in rows)} sites (each "
        f"geometry × its sites), {smi}, B = {batch}: `quant_act` v1 "
        f"{total['act_base_ms']:.4f} ms, v2 {total['act_ms']:.4f} ms (bound "
        f"{total['act_bound_ms']:.4f}); `qconv_int8` "
        f"{total['qconv_ms']:.4f} ms (bound {total['qconv_bound_ms']:.4f}); "
        f"cuDNN bf16 {total['cudnn_bf16_ms']:.4f} ms.")
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base", required=True)
    p.add_argument("--out", help="the rows as JSON")
    p.add_argument("--markdown", help="the table of docs/int8_sites_h100.md")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qconv_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    base = _nvcc.load_source(os.path.abspath(args.base), "qconv_ab_base")
    _nvcc.signature(base.quant_act, pointers=4, ints=5)
    qconv._lib()
    print(smi)
    for name, info in sorted(_nvcc.builds.items()):
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {info['seconds']:.1f} s; "
              + " | ".join(regs))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    _, qmodel = arc18_int8("cuda", SEED)
    sites = int8_sites_of(qmodel, torch.zeros((8, 3, 112, 112),
                                              device="cuda"))
    with torch.inference_mode():
        for key, found in sites.items():
            kind, shape, geo, dtype, _, co = key
            name, m, _ = found[0]
            xs = [torch.randn((BATCH,) + shape, generator=gen,
                              device="cuda", dtype=dtype) for _ in range(2)]
            want = base_act(base, xs[0], m.cp)
            got = qconv.quant_act(xs[0], m.cp)
            torch.cuda.synchronize()
            if not (torch.equal(want[0], got[0])
                    and torch.equal(want[1], got[1])):
                raise SystemExit(f"qconv_ab: {name}: base and current "
                                 "quant_act differ")
            fns = {"base": [lambda x=x: base_act(base, x, m.cp)
                            for x in xs],
                   "current": [lambda x=x: qconv.quant_act(x, m.cp)
                               for x in xs]}
            ms = {k: [] for k in fns}
            for which in ("base", "current", "current", "base"):
                ms[which].append(graph_ms(fns[which]))
            qs = [qconv.quant_act(x, m.cp) for x in xs]
            ops, conv_bytes, act_bytes = qconv.site_work(
                BATCH, shape, geo, co, xs[0].element_size())
            t_bytes, t_ops = conv_bytes / HBM_BYTES_PER_S, ops / INT8_OPS
            hw = 1 if len(shape) == 1 else shape[1] * shape[2]
            act = qconv.quant_act_plan(
                BATCH, shape[0], hw, xs[0].element_size(),
                qconv.cluster_cap(0, dtype == torch.bfloat16))
            row = {"site": name, "sites": len(found), "kind": kind,
                   "input": list(shape), "out_channels": co,
                   "geometry": list(geo),
                   "act_base_ms": min(ms["base"]),
                   "act_ms": min(ms["current"]),
                   "act_base_runs": ms["base"],
                   "act_runs": ms["current"],
                   "act_bound_ms": act_bytes / HBM_BYTES_PER_S * 1e3,
                   "act_plan": qconv.describe_act_plan(act),
                   "act_k": act.k,
                   "qconv_ms": graph_ms([lambda q=q: qconv.qconv_int8(
                       q[0], m.wp, q[1], m.sw, m.bias, list(geo), dtype)
                       for q in qs]),
                   "qconv_bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "plan": qconv.describe_plan(
                       qconv.qconv_plan(BATCH, m.cp, co, geo)),
                   "cudnn_bf16_ms": graph_ms(
                       [cudnn_call(m, x.to(torch.bfloat16), gen)
                        for x in xs])}
            rows.append(row)
            print(f"[ab] {name} (x{len(found)}) {kind} {list(shape)} -> "
                  f"{co} {list(geo)[:8]}: quant_act v1 "
                  f"{row['act_base_ms']:.4f} ms, v2 {row['act_ms']:.4f} ms "
                  f"({ms['base']} / {ms['current']}), bound "
                  f"{row['act_bound_ms']:.4f}, {row['act_plan']}; "
                  f"qconv_int8 {row['qconv_ms']:.4f} / "
                  f"{row['qconv_bound_ms']:.4f} ({row['bound_by']}); cuDNN "
                  f"bf16 {row['cudnn_bf16_ms']:.4f}")
            del xs, qs, want, got
            torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["sites"] for r in rows) for k in (
        "act_base_ms", "act_ms", "act_bound_ms", "qconv_ms",
        "qconv_bound_ms", "cudnn_bf16_ms")}
    print(f"[ab] {smi}: B = {BATCH}, summed over "
          f"{sum(r['sites'] for r in rows)} sites: quant_act v1 "
          f"{total['act_base_ms']:.4f} ms, v2 {total['act_ms']:.4f} ms "
          f"(bound {total['act_bound_ms']:.4f}); qconv_int8 "
          f"{total['qconv_ms']:.4f} (bound {total['qconv_bound_ms']:.4f}); "
          f"cuDNN bf16 {total['cudnn_bf16_ms']:.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "batch": BATCH, "rows": rows,
                       "total": total}, f, indent=1)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(markdown(rows, total, smi, BATCH))


if __name__ == "__main__":
    main()
