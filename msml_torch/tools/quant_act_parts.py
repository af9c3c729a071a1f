"""Where `quant_act`'s time goes on the card: its CUDA source built with one
part cut or changed, timed against the whole at arc18_msml's large inputs.

    python -m msml_torch.tools.quant_act_parts [--out FILE.json]

Each variant is a text edit of `csrc/qconv_int8.cu`, built with
`kernels/_nvcc.py`'s flags under its own name:
  no_codes       loads, the maximum and the cluster barrier; no codes
  no_loads       the maximum, the barrier, the codes and their stores from
                 shared memory that was never loaded
  no_stores      everything but the stores of the codes
  block_barrier  the cluster barrier replaced by a block barrier (each
                 block codes with its own maximum: wrong codes, time only)
  stores_only    no loads, constant codes stored
  ieee_division  the codes by `__fdiv_rn`, `rintf` and `__float2int_rn`, as
                 the first design computed them (the same bits)
  threads_256    blocks of 256 threads (4 an SM at most 64 registers)
and, with the built source, the plan's K = 16 at the 64 x 112² input
beside K = 8 (one block an SM), and `Tensor.copy_` of the same input (the
card's copy rate). B = 512 bf16, random inputs; device time of one call
from CUDA graphs of the calls (`qconv_ab.graph_ms`), the whole timed
first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from msml_torch.kernels import _nvcc, qconv
from msml_torch.tools.qconv_ab import HBM_BYTES_PER_S, graph_ms

BATCH = 512
SHAPES = ((64, 112, 112), (64, 56, 56), (512, 14, 14), (512, 7, 7),
          (25088,))
_CODES = "  // 3. the codes, 16-byte pieces\n"
_LOAD = "      cp_async16(dst + 16 * i, g0 - a + 16 * i, true);\n"
_STORE = ("      *reinterpret_cast<uint4*>(out + (size_t)pix * cp + cb) = "
          "codes;\n")
_CLUSTER_SYNC = ("    cluster.sync();  // every block's maximum is in its "
                 "slot\n")
_PIECE = ("        codes = nv >= 16 ? piece<T, true>(at, nv, d)\n"
          "                         : piece<T, false>(at, nv, d);\n")
_ARITH = """  const float q = __fmul_rn(v, d.y);
  const float t = __fmaf_rn(__fmaf_rn(-q, d.s, v), d.y, q);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(t, -127.f), 127.f), 12582912.f));
"""
_WAIT = ('  if (K > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\\n"'
         ' ::: "memory");\n')


def variants(src: str) -> dict:
    """{name: source} of the cut and changed builds."""
    for marker, count in ((_CODES, 1), (_LOAD, 1), (_STORE, 1),
                          (_CLUSTER_SYNC, 1), (_PIECE, 2), (_ARITH, 1),
                          (_WAIT, 1)):
        if src.count(marker) != count:
            raise SystemExit(f"quant_act_parts: {marker.strip()!r} found "
                             f"{src.count(marker)} times, not {count}")
    skip_codes = (_CODES + "  if (scale > 0.f) {  // always: no codes\n"
                  + _WAIT + "    return;\n  }\n")
    return {
        "no_codes": src.replace(_CODES, skip_codes),
        "no_loads": src.replace(_LOAD, "      ;\n"),
        "no_stores": src.replace(_STORE, "      if (codes.x == 0x12345678u "
                                 "&& codes.y == 0x9abcdef0u)\n  " + _STORE),
        "block_barrier": src.replace(_CLUSTER_SYNC,
                                     "    __syncthreads();\n"),
        "stores_only": src.replace(_LOAD, "      ;\n").replace(
            _PIECE, "        codes = make_uint4(pix, cb, 0, 0);\n"),
        "ieee_division": src.replace(_ARITH, """  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, d.s)), -127.f), 127.f);
  return static_cast<uint32_t>(__float2int_rn(q));
"""),
        "threads_256": src.replace(
            "constexpr int CT = 512;", "constexpr int CT = 256;").replace(
            "__launch_bounds__(CT, 2)", "__launch_bounds__(CT, 4)"),
    }


def call(lib, x, plan: qconv.ActPlan):
    """One launch of `lib`'s quant_act on x with `plan` -> (fn, xq, sx)."""
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    cp = qconv.padded_channels(c)
    arr = plan.array()
    xq = torch.empty((n, hw, cp), dtype=torch.int8, device=x.device)
    sx = torch.empty((n,), dtype=torch.float32, device=x.device)

    def fn():
        err = lib.quant_act(x.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                            None, arr.ctypes.data, n, c, hw, cp,
                            int(x.dtype == torch.bfloat16),
                            torch.cuda.current_stream().cuda_stream)
        _nvcc.check(lib, err, "quant_act")
    return fn, xq, sx


def cluster_plan(c: int, hw: int, esize: int, k: int) -> qconv.ActPlan:
    """The plan's layout at a cluster of k blocks."""
    p = -(-(-(-hw // k)) // 8) * 8
    rowb = -(-p * esize // 16) * 16 + 16
    return qconv.ActPlan(k, p, rowb, qconv.act_smem(c, hw, rowb, esize))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="the times as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_act_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_nvcc.CSRC, "qconv_int8.cu")) as f:
        sources = variants(f.read())
    os.makedirs(_nvcc.BUILD_DIR, exist_ok=True)
    paths = {}
    for name, text in sources.items():
        paths[name] = os.path.join(_nvcc.BUILD_DIR, f"parts_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda kv: _nvcc.load_source(kv[1], f"parts_{kv[0]}"),
            paths.items())))
    for lib in libs.values():
        _nvcc.signature(lib.quant_act, pointers=5, ints=5)
    whole = qconv._lib()
    print(smi)

    rows = []
    for shape in SHAPES:
        x = torch.randn((BATCH,) + shape, device="cuda",
                        dtype=torch.bfloat16)
        c, hw = shape[0], x[0, 0].numel()
        plan = qconv.quant_act_plan(BATCH, c, hw, 2,
                                    qconv.cluster_cap(0, True))
        ref = qconv.quant_act_reference(x, qconv.padded_channels(c))
        row = {"input": list(shape), "plan": qconv.describe_act_plan(plan),
               "whole_ms": graph_ms([call(whole, x, plan)[0]])}
        for name, lib in libs.items():
            fn, xq, sx = call(lib, x, plan)
            row[f"{name}_ms"] = graph_ms([fn])
            if name in ("ieee_division", "threads_256"):
                torch.cuda.synchronize()
                row[f"{name}_equal"] = (torch.equal(xq.view(ref[0].shape),
                                                    ref[0])
                                        and torch.equal(sx, ref[1]))
        row["whole_again_ms"] = graph_ms([call(whole, x, plan)[0]])
        if shape == SHAPES[0]:
            for k in (16, 8):
                other = cluster_plan(c, hw, 2, k)
                row[f"k{k}_ms"] = graph_ms([call(whole, x, other)[0]])
                row[f"k{k}_clusters_resident"] = qconv.act_occupancy(
                    True, k, other.smem)[0]
            y = torch.empty_like(x)
            copy_ms = graph_ms([lambda: y.copy_(x)])
            row["copy_ms"] = copy_ms
            row["copy_tb_s"] = 2 * x.numel() * x.element_size() / (
                copy_ms * 1e-3) / 1e12
            row["bound_ms"] = (x.numel() * 2 + BATCH * hw
                               * qconv.padded_channels(c)) / HBM_BYTES_PER_S \
                * 1e3
        rows.append(row)
        print(f"[parts] {list(shape)} {row['plan']}: " + ", ".join(
            f"{k[:-3] if k.endswith('_ms') else k} "
            + (f"{v:.4f}" if isinstance(v, float) else str(v))
            for k, v in row.items() if k not in ("input", "plan")))
        del x, ref
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "batch": BATCH, "rows": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
