"""The launch plan of the activation quantizer's cluster kernel
(`msml_torch/kernels/qconv.py::quant_act_plan`), and its data movement
replayed in numpy as `act_cluster` in csrc/qconv_int8.cu walks it.

The replay stages each block's rows into a byte image of its shared
memory (whole aligned 16-byte windows, so that a row lies at its global
address modulo 16; no two windows on one shared byte, each element of x
staged exactly once), takes each block's maximum from what it staged, the
cluster's maximum over its blocks, and builds the codes as the kernel's
lanes do, in 16-byte pieces, from the staged bytes only: a pixel's pieces
by half-warps 16 channels apart, the fc's flat row with the lane's
rotated read order and the kernel's rotation back. It checks that no warp
access meets a bank conflict and that each piece is written once, and is
held bit for bit to `quant_act_reference` (itself held to the JAX
package's quantizer in tests/test_torch_quantize.py).
"""

import numpy as np
import pytest
import torch

from msml_torch.kernels import qconv
from test_torch_qconv_plan import B_MAIN, SITES

ESIZE = {torch.bfloat16: 2, torch.float32: 4}


def owned(plan: qconv.ActPlan, hw: int):
    """[p0, p1) of each block of a sample's cluster."""
    return [(k * plan.p, max(k * plan.p, min(hw, (k + 1) * plan.p)))
            for k in range(plan.k)]


def forced(c: int, hw: int, esize: int, k: int) -> qconv.ActPlan:
    """The plan's layout at a cluster of k blocks, whatever it would pick."""
    p = hw if k == 1 else -(-(-(-hw // k)) // 8) * 8
    rowb = -(-p * esize // 16) * 16 + 16
    return qconv.ActPlan(k, p, rowb, qconv.act_smem(c, hw, rowb, esize))


# -- the plan at arc18_msml's sites ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("site", SITES, ids=[s[-1] for s in SITES])
def test_plan_of_each_site(site, dtype):
    """Each site's input at B = 512 takes the cluster route with a K the
    card places, a block that fits (two an SM in bf16), rows that hold a
    block's pixels wherever they start modulo 16, and every pixel owned by
    exactly one block."""
    _, shape, _, _, _, name = site
    c, h, w = (shape[0], 1, 1) if len(shape) == 1 else shape
    hw, es = h * w, ESIZE[dtype]
    plan = qconv.quant_act_plan(B_MAIN, c, hw, es)
    assert plan.route == "cluster"
    assert plan.k in qconv.CLUSTER_SIZES
    budget = qconv.SMEM_PAIR if dtype == torch.bfloat16 else qconv.SMEM_BLOCK
    assert plan.smem == qconv.act_smem(c, hw, plan.rowb, es) <= budget
    if hw == 1:
        assert (plan.k, plan.p, plan.rowb) == (1, 1, 0)
        # the sample's c elements from any start modulo 16
        assert plan.smem - qconv.ACT_SCRATCH >= c * es + 15
    else:
        assert plan.p == hw if plan.k == 1 else plan.p % 8 == 0
        assert plan.rowb % 16 == 0 and plan.rowb >= plan.p * es + 15
        # the least K whose block fits the budget
        if plan.k > 1:
            smaller = forced(c, hw, es, plan.k // 2)
            assert smaller.smem > budget or (
                dtype == torch.float32 and smaller.smem > qconv.SMEM_PAIR)
    counts = np.zeros(hw, int)
    for p0, p1 in owned(plan, hw):
        counts[p0:p1] += 1
    assert (counts == 1).all(), name
    assert np.array_equal(plan.array(), np.array(plan, dtype=np.int32))


def test_plan_of_the_large_inputs():
    """The shapes the design is sized by (B = 512)."""
    plan = qconv.quant_act_plan
    assert plan(B_MAIN, 64, 112 * 112, 2)[:2] == (16, 784)
    assert plan(B_MAIN, 64, 112 * 112, 2).smem <= qconv.SMEM_PAIR
    assert plan(B_MAIN, 64, 56 * 56, 2)[:2] == (4, 784)
    assert plan(B_MAIN, 64, 28 * 28, 2)[:2] == (1, 784)
    assert plan(B_MAIN, 25088, 1, 2) == (1, 1, 0, plan(B_MAIN, 25088, 1, 2)
                                         .smem)
    # a float32 64 x 112² sample: 16 blocks of about 200 KB, one an SM
    f32 = plan(B_MAIN, 64, 112 * 112, 4)
    assert f32.k == 16 and qconv.SMEM_PAIR < f32.smem <= qconv.SMEM_BLOCK


@pytest.mark.parametrize("cap", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plan_within_cap(cap, dtype):
    """No plan asks for a cluster larger than the card places; a sample
    that no allowed cluster holds takes the two-pass route."""
    es = ESIZE[dtype]
    for _, shape, _, _, _, _ in SITES:
        c, h, w = (shape[0], 1, 1) if len(shape) == 1 else shape
        plan = qconv.quant_act_plan(B_MAIN, c, h * w, es, cap)
        if plan.route == "two-pass":
            assert cap < 16
            assert all(forced(c, h * w, es, k).smem > qconv.SMEM_BLOCK
                       for k in qconv.CLUSTER_SIZES if k <= cap)
        else:
            assert plan.k <= cap and plan.smem <= qconv.SMEM_BLOCK


def test_oversized_samples_take_two_passes():
    """Picked by shape: a sample over 16 blocks' shared memory, or an fc
    row over one block's."""
    assert qconv.quant_act_plan(8, 64, 128 * 128, 4).route == "two-pass"
    assert qconv.quant_act_plan(8, 64, 128 * 128, 2).route == "cluster"
    assert qconv.quant_act_plan(8, 60000, 1, 4).route == "two-pass"
    assert qconv.quant_act_plan(8, 25088, 16, 2).route == "two-pass"
    with pytest.raises(ValueError, match="batch"):
        qconv.quant_act_plan(65536, 64, 16, 2)


# -- the numpy replay -------------------------------------------------------

def decode(data: np.ndarray, addr: np.ndarray, es: int) -> np.ndarray:
    """float32 values of the T elements at byte addresses addr."""
    b = data[addr[..., None] + np.arange(es)]
    if es == 4:
        return np.ascontiguousarray(b).view(np.float32)[..., 0]
    bits = np.ascontiguousarray(b).view(np.uint16)[..., 0].astype(np.uint32)
    return (bits << 16).view(np.float32)


def codes(v: np.ndarray, s: np.float32) -> np.ndarray:
    """`code_bits`' low bytes, as the kernel rounds them: q = RN(v y) with
    y = RN(1 / s), t = fma(fma(-q, s, v), y, q), the clip, then + 1.5 2^23
    in float32 (its low byte is the code)."""
    v = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    if np.isinf(s):
        s, y = np.float32(np.finfo(np.float32).max), np.float32(0)
    else:
        y = np.float32(1) / np.float32(s)
    sy = [torch.full_like(v, float(a)) for a in (s, y)]
    q = v * sy[1]
    t = qconv.fma_f32(qconv.fma_f32(-q, sy[0], v), sy[1], q).numpy()
    c = np.fmin(np.fmax(t, np.float32(-127)), np.float32(127))  # fmaxf
    return ((c + np.float32(12582912.0)).view(np.uint32) & 0xff).astype(
        np.uint8)


def test_codes_are_ieee_division():
    """The kernel's FMA-pipe rounding gives clip(rint(v / s), +-127) with
    v / s an IEEE division: every finite bf16 value up to 200 s, normal
    float32 values and the float32 neighbours of every tie (k + 1/2) s, at
    the scales of random samples, of amaxes with all-ones significands and
    of powers of two, and at the floor 1e-12; an infinite scale gives 0 for
    finite values and -127 (NaN clipped) for infinite ones."""
    rng = np.random.default_rng(0)
    bf16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    bf16 = bf16[np.isfinite(bf16)]
    amax = np.concatenate([
        np.abs(rng.standard_normal(24)).astype(np.float32) * 10,
        (np.uint32(0x3f7fffff) - np.arange(6, dtype=np.uint32)).view(
            np.float32) * 3,
        np.float32(2.0) ** np.arange(-40, 41, 8, dtype=np.float32),
        np.float32([0.0, 127.0])])
    ties = np.arange(-128, 128, dtype=np.float32) + np.float32(0.5)
    for a in amax:
        s = max(np.float32(a) * np.float32(qconv.INV_QMAX),
                np.float32(qconv.EPS))
        t = (ties * s).astype(np.float32)
        v = np.concatenate([
            bf16[np.abs(bf16) <= s * 200], t,
            np.nextafter(t, np.float32(np.inf)),
            np.nextafter(t, np.float32(-np.inf)),
            (rng.standard_normal(4096) * s * 60).astype(np.float32)])
        want = np.clip(np.rint(v / s), -127, 127).astype(np.int8)
        assert np.array_equal(codes(v, s), want.view(np.uint8)), a
    v = np.float32([0.0, -3.0, 3e38, np.inf, -np.inf])
    assert codes(v, np.float32(np.inf)).view(np.int8).tolist() == [
        0, 0, 0, -127, -127]


def rotate_piece(w, r: int):
    """The kernel's rotation of the 16 bytes in words w up by r bytes:
    words by r / 4, then a funnel shift by 8 (r % 4) bits."""
    r = int(r)
    kw, sh = r >> 2, 8 * (r & 3)
    x0, x1, x2, x3 = (int(v) for v in w)
    if kw & 1:
        x0, x1, x2, x3 = x3, x0, x1, x2
    if kw & 2:
        x0, x1, x2, x3 = x2, x3, x0, x1

    def funnel(lo, hi):  # __funnelshift_l(lo, hi, sh)
        return ((((hi << 32) | lo) << sh) >> 32) & 0xffffffff

    return [funnel(x3, x0), funnel(x0, x1), funnel(x1, x2), funnel(x2, x3)]


def no_bank_conflict(addr: np.ndarray) -> bool:
    """The 4-byte words a warp reads at once lie in distinct banks."""
    words = np.unique(addr // 4)
    return np.unique(words % 32).size == words.size


def stage(data, staged, copied, mem, g0, nbytes, dst):
    """A row's staging: bytes [g0, g0 + nbytes) of mem to data at dst (dst
    = g0 modulo 16) as whole 16-byte windows (g0 & ~15) + 16 i; `staged`
    marks the row's own bytes, `copied` every byte a window wrote."""
    assert dst % 16 == g0 % 16
    a = g0 % 16
    for i in range(-(-(a + nbytes) // 16) if nbytes else 0):
        w = g0 - a + 16 * i
        to = np.arange(dst - a + 16 * i, dst - a + 16 * i + 16)
        assert not copied[to].any(), "two windows on one shared byte"
        data[to] = mem[w:w + 16]
        copied[to] = True
        inside = (np.arange(w, w + 16) >= g0) & (np.arange(w, w + 16)
                                                 < g0 + nbytes)
        staged[to[inside]] = True


def replay(x: torch.Tensor, cp: int, plan: qconv.ActPlan, start: int):
    """(xq (n, hw, cp) int8, sx (n,) float32) as `act_cluster` computes
    them, x's first byte at global address `start`."""
    n, c = x.shape[:2]
    hw = int(np.prod(x.shape[2:])) if x.dim() > 2 else 1
    es = x.element_size()
    bits = torch.int16 if es == 2 else torch.int32
    # x's bytes among others (a window may reach past either end)
    mem = np.full(start + x.numel() * es + 32, 0x7f, np.uint8)
    mem[start:start + x.numel() * es] = (
        x.contiguous().view(bits).numpy().view(np.uint8).ravel())
    flat, skew = hw == 1, qconv.ACT_SKEW
    rows_end = c * plan.rowb + skew * ((c - 1) // 16)
    # the staged data; the slots follow it
    buf = plan.smem - qconv.ACT_SCRATCH
    xq = np.zeros((n, hw, cp), np.uint8)
    written = np.zeros((n, hw, cp // 16), int)
    sx = np.zeros(n, np.float32)
    for s in range(n):
        blocks = []
        for k, (p0, p1) in enumerate(owned(plan, hw)):
            data = np.full(buf, 0xff, np.uint8)  # NaN until staged
            staged = np.zeros(buf, bool)
            copied = np.zeros(buf, bool)
            table = np.zeros(c, np.int64)
            if flat:
                g0 = start + s * c * es
                stage(data, staged, copied, mem, g0, c * es, g0 % 16)
                table[:] = g0 % 16 + np.arange(c) * es
            else:
                for ch in range(c):
                    g0 = start + ((s * c + ch) * hw + p0) * es
                    base = ch * plan.rowb + skew * (ch >> 4)
                    stage(data, staged, copied, mem, g0, (p1 - p0) * es,
                          base + g0 % 16)
                    # the row's windows stay within its rowb bytes
                    assert not copied[base + plan.rowb:rows_end].any()
                    table[ch] = base + g0 % 16
                assert not copied[rows_end:].any()
                if (hw * es) % 16 == 0 and (plan.p * es) % 16 == 0:
                    # the kernel's `even` rows: one start modulo 16, so
                    # channel cb + j lies j rowb after the group's first
                    bases = (np.arange(c) * plan.rowb
                             + skew * (np.arange(c) >> 4))
                    assert np.unique(table - bases).size == 1
            # the block's maximum over what it staged: every element once
            pix = 1 if flat else p1 - p0
            assert staged.sum() == c * pix * es
            vals = decode(data, table[:, None] + np.arange(pix) * es, es)
            blocks.append((p0, p1, data, staged, table,
                           np.float32(np.abs(vals).max(initial=0.0))))
        amax = max(b[-1] for b in blocks)
        sx[s] = max(np.float32(amax) * np.float32(qconv.INV_QMAX),
                    np.float32(qconv.EPS))
        for p0, p1, data, staged, table, _ in blocks:
            if flat:
                build_flat(xq[s, 0], written[s, 0], data, staged, table, c,
                           cp, es, sx[s])
            else:
                build_rows(xq[s, p0:p1], written[s, p0:p1], data, staged,
                           table, c, cp, es, sx[s])
    assert (written == 1).all(), "a piece written twice or never"
    return xq.view(np.int8), sx


def build_rows(out, written, data, staged, table, c, cp, es, s):
    """Warp task (pb, gp): lane l builds pixel 16 pb + l % 16, channels
    32 gp + 16 (l / 16) .. + 15, reading the table's row offsets."""
    pl, gl = np.arange(32) % 16, np.arange(32) // 16
    npb, g2 = -(-out.shape[0] // 16), cp // 32
    for t in range(npb * g2):
        pb, gp = divmod(t, g2)
        pix, cb = 16 * pb + pl, 32 * gp + 16 * gl
        live = pix < out.shape[0]
        piece = np.zeros((32, 16), np.uint8)
        for j in range(16):
            ch = cb + j
            on = live & (ch < c)
            addr = table[np.minimum(ch, c - 1)] + pix * es
            assert staged[addr[on, None] + np.arange(es)].all()
            assert no_bank_conflict(addr[on])
            v = np.where(on, decode(data, np.where(on, addr, 0), es), 0.0)
            piece[:, j] = codes(v, s)
        for lane in np.flatnonzero(live):
            g = cb[lane] // 16
            out[pix[lane], 16 * g:16 * g + 16] = piece[lane]
            written[pix[lane], g] += 1


def build_flat(out, written, data, staged, table, c, cp, es, s):
    """Thread g builds piece g of the row: at step j lane l = g % 32
    reads channel 16 g + (j + r) % 16, r = l / 2 (float32) or 2 (l / 4)
    (bf16), then rotates the piece back by r."""
    g = np.arange(cp // 16)
    r = (g % 32) // (8 // es) * (4 // es)
    rotated = np.zeros((g.size, 16), np.uint8)
    for j in range(16):
        ch = 16 * g + ((j + r) & 15)
        on = ch < c
        addr = table[np.minimum(ch, c - 1)]
        assert staged[addr[on, None] + np.arange(es)].all()
        for w0 in range(0, g.size, 32):  # one warp's loads
            warp = slice(w0, w0 + 32)
            assert no_bank_conflict(addr[warp][on[warp]])
        rotated[:, j] = codes(np.where(on, decode(data, np.where(
            on, addr, 0), es), 0.0), s)
    words = rotated.view("<u4")
    for i in g:
        out[16 * i:16 * i + 16] = np.array(rotate_piece(words[i], r[i]),
                                           "<u4").view(np.uint8)
        written[i] += 1


def test_rotation_is_a_byte_rotation():
    rng = np.random.default_rng(0)
    for r in range(16):
        b = rng.integers(0, 256, 16, dtype=np.uint8)
        got = np.array(rotate_piece(b.view("<u4"), r), "<u4").view(np.uint8)
        assert np.array_equal(got, np.roll(b, r)), r


def sample(gen, n, c, hw, dtype, offset):
    """x (n, c, hw) as the kernel would meet it: sample 0 scaled up,
    sample 1 (if any) all zero, sample 2 (if any) exact ties at .5 (amax
    127, so sx = 1); `offset` elements past an aligned start."""
    x = gen.standard_normal((n, c, hw)).astype(np.float32)
    x[0] *= 5.0
    if n > 1:
        x[1] = 0.0
    if n > 2:
        ties = gen.integers(-127, 127, (c, hw)) + 0.5
        ties.flat[0] = 127.0
        x[2] = ties
    t = torch.from_numpy(x).to(dtype)
    return t.view(n, c) if hw == 1 else t.view(n, c, hw, 1), \
        16 * 8 + offset * ESIZE[dtype]


REPLAY = [(18, 1), (82, 1), (530, 1), (25088, 1), (18, 16), (82, 16),
          (530, 16), (18, 49), (82, 49), (530, 49), (18, 196), (82, 196),
          (530, 196)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("c,hw", REPLAY, ids=[f"c{c}_hw{hw}"
                                              for c, hw in REPLAY])
def test_replay_bit_equal_reference(c, hw, dtype, offset):
    gen = np.random.default_rng(c * 1000 + hw)
    n = 2 if c == 25088 else 3
    x, start = sample(gen, n, c, hw, dtype, offset)
    cp = qconv.padded_channels(c)
    plan = qconv.quant_act_plan(n, c, hw, ESIZE[dtype])
    assert plan.route == "cluster"
    xq, sx = replay(x, cp, plan, start)
    want_q, want_s = qconv.quant_act_reference(x, cp)
    assert np.array_equal(sx, want_s.numpy())
    assert np.array_equal(xq, want_q.numpy().reshape(n, hw, cp))
    if n > 1:
        assert sx[1] == np.float32(qconv.EPS) and not xq[1].any()
    if n > 2:
        assert sx[2] == 1.0  # the ties: rint half to even
        q = xq[2].astype(np.float32).T[:c]
        v = x[2].float().numpy().reshape(c, hw)
        assert np.array_equal(q, np.rint(v)) and (np.abs(q) % 2 == 0)[
            v % 1 != 0].all()


@pytest.mark.parametrize("k", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_replay_clusters(k, dtype):
    """Clusters of every size on one small shape, one element off: blocks
    that own a tail or no pixel at all still join the maximum."""
    gen = np.random.default_rng(k)
    c, hw = 82, 196
    x, start = sample(gen, 3, c, hw, dtype, 1)
    cp = qconv.padded_channels(c)
    plan = forced(c, hw, ESIZE[dtype], k)
    xq, sx = replay(x, cp, plan, start)
    want_q, want_s = qconv.quant_act_reference(x, cp)
    assert np.array_equal(sx, want_s.numpy())
    assert np.array_equal(xq, want_q.numpy().reshape(3, hw, cp))


def test_parts_tool_finds_its_markers():
    """`tools/quant_act_parts.py` edits the kernel's source by text: every
    variant applies to the source as it stands and changes it."""
    from msml_torch.kernels import _nvcc
    from msml_torch.tools import quant_act_parts

    with open(f"{_nvcc.CSRC}/qconv_int8.cu") as f:
        src = f.read()
    built = quant_act_parts.variants(src)
    assert sorted(built) == sorted([
        "no_codes", "no_loads", "no_stores", "block_barrier", "stores_only",
        "ieee_division", "threads_256"])
    assert all(text != src for text in built.values())
