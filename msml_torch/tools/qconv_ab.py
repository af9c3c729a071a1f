"""Time `qconv_int8` against another build of its CUDA source, at every
distinct int8 geometry of arc18_msml's quantized eval forward, on the card.

    python -m msml_torch.tools.qconv_ab --base <dir>/qconv_int8.cu \\
        [--strip] [--out FILE.json] [--markdown FILE.md]

`--base` is a `csrc/qconv_int8.cu` with the plain C entry point of its
first design, `qconv_int8(xq, wp, sx, sw, bias, y, n, h, w, cp, co, ho, wo,
kh, kw, sh, sw, ph, pw, dh, dw, bf16, stream)` (for instance a parent
commit's, unpacked with `git archive` into a gitignored directory). Both
are built with `kernels/_nvcc.py`'s flags. The geometries are those of
`configs/arc18_msml.yaml` (random weights from seed 0, bf16, quantized by
`core/quantize.quantize_eval_model`), each at B = 512 on random inputs.
Per geometry, in turns base, current, current, base: the device time of
one call from CUDA graphs of the calls on two inputs (the median of 3
replays; the smaller of each build's two turns), and both outputs bit
for bit equal. Beside them: the bound (the larger of the bytes at 3.35
TB/s and the real int8 operations at 1,979 TOPS, `kernels/qconv.py::
site_work`), the plan the current kernel was launched with, `quant_act`'s
time and bound, and cuDNN's bf16 op of the same shape (`F.conv2d`,
`F.conv_transpose2d`, `F.linear` on random weights: the yardstick, not a
path of the port). Prints one line per geometry and the sums weighted by
each geometry's number of sites; `--out` writes the rows as JSON and
`--markdown` the table of `docs/int8_sites_h100.md`.

`--strip` times only the 112² conv `frb.layer1.0.conv1`,
`osb.layer1.0.conv1` and `osb.deconv5`, and beside them the base built
with the stores of its epilogue removed (the accumulators folded into one
word, stored only if it takes a value it cannot take) and with each
`mma.sync` replaced by an XOR of its fragments: how the base's time
splits into the main loop's loads, its MMAs and the stores.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile

import torch

from msml_torch.kernels import _nvcc, qconv

SPLIT_SITES = ("frb.layer1.0.conv1", "osb.layer1.0.conv1", "osb.deconv5")
BATCH, SEED = 512, 0       # the quantized eval forward's batch; weights
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate
INT8_OPS = 1979e12         # its dense int8 tensor-core peak (operations / s)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "arc18_msml.yaml")

# the first design's epilogue and MMA, as its source spells them
_EPILOGUE = "  // epilogue: float(acc) * (sx[n] * sw[co]) and the bias, to OUT"
_KERNEL_END = "\n}\n\n}  // namespace"
_NO_STORE = """  // stores stripped: the accumulators folded into one word
  int sink = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) sink ^= acc[mi][ni][r];
  if (sink == 0x7fffffff) store(y + t, (float)sink, 1.f, nullptr);"""
_MMA = "mma_s8(acc[mi][ni], af[mi], bfr[ni]);"
_NO_MMA = ("acc[mi][ni][0] ^= af[mi][0] ^ af[mi][1] ^ af[mi][2] ^ "
           "af[mi][3] ^ bfr[ni][0] ^ bfr[ni][1];")


def stripped_sources(base: str, scratch: str) -> dict:
    """{variant: path} of the base source with its stores, or its MMAs,
    stripped."""
    with open(base) as f:
        src = f.read()
    start, end = src.find(_EPILOGUE), src.find(_KERNEL_END)
    if start < 0 or end < start or src.count(_MMA) != 1:
        raise SystemExit(f"{base}: not the first design's source (its "
                         "epilogue or MMA not found)")
    out = {}
    for variant, text in (("no_store", src[:start] + _NO_STORE + src[end:]),
                          ("no_mma", src.replace(_MMA, _NO_MMA))):
        path = os.path.join(scratch, f"qconv_int8_{variant}.cu")
        with open(path, "w") as f:
            f.write(text)
        out[variant] = path
    return out


def base_call(lib, xq, m, sx, geo, dtype):
    """The base build's qconv_int8 on the module m's weights -> y."""
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geo
    n, h, w, cp = xq.shape
    co = m.sw.shape[0]
    y = torch.empty((n, co, ho, wo), dtype=dtype, device=xq.device)
    err = lib.qconv_int8(xq.data_ptr(), m.wp.data_ptr(), sx.data_ptr(),
                         m.sw.data_ptr(),
                         None if m.bias is None else m.bias.data_ptr(),
                         y.data_ptr(), n, h, w, cp, co, ho, wo, kh, kw, sh,
                         swd, ph, pw, dh, dw, int(dtype == torch.bfloat16),
                         torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "base qconv_int8")
    return y


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
        "| Site (×sites) | Kind | Input | Out | Kernel | v1 | v2 | bound | by "
        "| v2 plan | quant_act | bound | cuDNN bf16 |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        kh, kw, sh, _, _, _, dh = r["geometry"][:7]
        kernel = f"{kh}×{kw}" + (f" s{sh}" if sh > 1 else "") + (
            f" lhs-dil {dh}" if dh > 1 else "")
        lines.append(
            f"| `{r['site']}` (×{r['sites']}) | {r['kind']} | "
            f"{dims(r['input'])} | {r['out_channels']} | {kernel} | "
            f"{r['base_ms']:.4f} | {r['current_ms']:.4f} | "
            f"{r['bound_ms']:.4f} | {r['bound_by']} | {r['plan']} | "
            f"{r['quant_act_ms']:.4f} | {r['quant_act_bound_ms']:.4f} | "
            f"{r['cudnn_bf16_ms']:.4f} |")
    lines.append("")
    lines.append(
        f"Summed over all {sum(r['sites'] for r in rows)} sites (each "
        f"geometry × its sites), {smi}, B = {batch}: `qconv_int8` v1 "
        f"{total['base_ms']:.4f} ms, v2 {total['current_ms']:.4f} ms (bound "
        f"{total['bound_ms']:.4f}); `quant_act` {total['quant_act_ms']:.4f} "
        f"ms (bound {total['quant_act_bound_ms']:.4f}); cuDNN bf16 "
        f"{total['cudnn_bf16_ms']:.4f} ms.")
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base", required=True)
    p.add_argument("--strip", action="store_true")
    p.add_argument("--out", help="the rows as JSON")
    p.add_argument("--markdown", help="the table of docs/int8_sites_h100.md")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qconv_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    scratch = tempfile.mkdtemp(prefix="qconv_ab_")
    sources = {"base": os.path.abspath(args.base)}
    if args.strip:
        sources.update(stripped_sources(args.base, scratch))
    libs = {k: _nvcc.load_source(v, f"qconv_ab_{k}")
            for k, v in sources.items()}
    for lib in libs.values():
        _nvcc.signature(lib.qconv_int8, pointers=6, ints=16)
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
            if args.strip and name not in SPLIT_SITES:
                continue
            xs = [torch.randn((BATCH,) + shape, generator=gen,
                              device="cuda", dtype=dtype) for _ in range(2)]
            qs = [qconv.quant_act(x, m.cp) for x in xs]
            want = qconv.qconv_int8(qs[0][0], m.wp, qs[0][1], m.sw, m.bias,
                                    list(geo), dtype)
            got = base_call(libs["base"], qs[0][0], m, qs[0][1], geo, dtype)
            torch.cuda.synchronize()
            if not torch.equal(want, got):
                raise SystemExit(f"qconv_ab: {name}: base and current "
                                 "differ")

            def fns(which):
                if which == "current":
                    return [lambda q=q: qconv.qconv_int8(
                        q[0], m.wp, q[1], m.sw, m.bias, list(geo), dtype)
                        for q in qs]
                return [lambda q=q: base_call(libs[which], q[0], m, q[1],
                                              geo, dtype) for q in qs]

            ms = {k: [] for k in ("base", "current")}
            for which in ("base", "current", "current", "base"):
                ms[which].append(graph_ms(fns(which)))
            ops, conv_bytes, act_bytes = qconv.site_work(
                BATCH, shape, geo, co, xs[0].element_size())
            t_bytes, t_ops = conv_bytes / HBM_BYTES_PER_S, ops / INT8_OPS
            row = {"site": name, "sites": len(found), "kind": kind,
                   "input": list(shape), "out_channels": co,
                   "geometry": list(geo), "plan": qconv.describe_plan(
                       qconv.qconv_plan(BATCH, m.cp, co, geo)),
                   "base_ms": min(ms["base"]),
                   "current_ms": min(ms["current"]),
                   "base_runs": ms["base"], "current_runs": ms["current"],
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "quant_act_ms": graph_ms(
                       [lambda x=x: qconv.quant_act(x, m.cp) for x in xs]),
                   "quant_act_bound_ms": act_bytes / HBM_BYTES_PER_S * 1e3,
                   "cudnn_bf16_ms": graph_ms(
                       [cudnn_call(m, x.to(torch.bfloat16), gen)
                        for x in xs])}
            if args.strip:
                for v in ("no_store", "no_mma"):
                    row[f"base_{v}_ms"] = graph_ms(fns(v))
            rows.append(row)
            print(f"[ab] {name} (x{len(found)}) {kind} {list(shape)} -> "
                  f"{co} {list(geo)[:8]}: base {row['base_ms']:.4f} ms, "
                  f"current {row['current_ms']:.4f} ms ({ms['base']} / "
                  f"{ms['current']}), bound {row['bound_ms']:.4f} "
                  f"({row['bound_by']}); quant_act "
                  f"{row['quant_act_ms']:.4f}; cuDNN bf16 "
                  f"{row['cudnn_bf16_ms']:.4f}; plan {row['plan']}"
                  + ("".join(f"; base {v} {row[f'base_{v}_ms']:.4f} ms"
                             for v in ("no_store", "no_mma"))
                     if args.strip else ""))
            del xs, qs, want, got
            torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["sites"] for r in rows) for k in (
        "base_ms", "current_ms", "bound_ms", "quant_act_ms",
        "quant_act_bound_ms", "cudnn_bf16_ms")}
    print(f"[ab] {smi}: B = {BATCH}, summed over "
          f"{sum(r['sites'] for r in rows)} sites: base "
          f"{total['base_ms']:.4f} ms, current {total['current_ms']:.4f} ms "
          f"(bound {total['bound_ms']:.4f}); quant_act "
          f"{total['quant_act_ms']:.4f}; cuDNN bf16 "
          f"{total['cudnn_bf16_ms']:.4f}")
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
