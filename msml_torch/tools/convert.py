"""Convert between msml_tpu (flax) parameter trees and the port's state dict.

The port's own copy of the exporter `msml_tpu/tools/export_torch.py` and of
its inverse `msml_tpu/tools/import_torch.py::import_msml_checkpoint`, for
the modules the port has: the iResNet trunk, the LightCNN-29v2 trunk
(detected by `frb.conv1.filter`, `import_torch.py:200-208`; each mfm conv
`<name>.filter` with its bias), the FMCnn operators with
their peer-guided parts (`conv_m` as `.conv_m.0` / `.conv_m.1`, the towers
`conv1` / `conv2` as `.0` to `.5`), the frozen iResNet teacher (`peer` ->
`frb.peer.*`), the recover decoder (`frb/decoder` -> `frb.decoder.*`, under
the flax names: the JAX exporter refuses a decoder and so names none), the
U-Net and the classification head; and, with `network`, the eval-only
baselines of `cli.test --network`: `Sphere` (`import_torch.py:257-277`),
the BasicBlock `ResNet` (torchvision's names; JAX has no importer) and
`LResNetOcc` / `From2021` (`import_torch.py:287-347`; From2021's flax tree
sits under `model`). The trees are nested dicts of numpy
arrays (e.g. from `jax.device_get`); no JAX or flax is needed here. The
state dict carries the reference's torch names, so
`MSML.load_state_dict(..., strict=True)` takes it.

Layouts (flax -> torch; the inverse undoes each):
  conv   (kh, kw, I, O) -> (O, I, kh, kw)
  deconv (kh, kw, O, I) -> (I, O, kh, kw)
  frb.fc (H*W*C, out)   -> (out, C*H*W): the flax model flattens HWC, the
                           reference and the port flatten C-major; H = W = 7,
                           C = 512 for iResNet, H = W = 8, C = 128 for
                           LightCNN (`export_torch.py:222`); the
                           baselines' fc and FROM's `regress.2` / `fc.2` at
                           their last map (7 x 6 x 512 at 112 x 96)
  BN1d over a flatten   -> FROM's `regress.0` / `fc.0`: each vector from
                           HWC to C-major order (`_flat_perm`,
                           `import_torch.py:279-284`)
  BN     scale/bias/mean/var -> weight/bias/running_mean/running_var
                                (+ num_batches_tracked = 0)
  features BatchNorm1d  -> weight = ones (frozen at 1.0, iresnet.py:119-120;
                           flax has use_scale=False, so the inverse drops it)
  classification        -> weight (num_classes, dim) as it is, + bias for
                           Softmax (`msml_tpu/tools/export_torch.py:248-253`)

`flatten` / `unflatten` are flax's `traverse_util` dicts with `/`-joined
keys, the key scheme of the `.npz` files of `tools/export_frb.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from msml_torch.nn.baselines import final_map

Path = Tuple[str, ...]
FC_HW = (7, 7)  # iResNet's final 7 x 7 map at 112 input
LIGHT_FC_HW = (8, 8)  # LightCNN's final 8 x 8 map at 128 input


def _get(tree, path: Path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _has(tree, path: Path) -> bool:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def _set(tree: Dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class _Layout:
    """One walk over the modules that records each torch key beside the
    flax leaf it comes from: (key, tree 'params' / 'batch_stats' / None,
    flax path, kind). `has(flax path, torch key prefix)` says whether a
    module is there, asked of whichever side the conversion starts from."""

    def __init__(self, has: Callable[[Path, str], bool]):
        self.has = has
        self.leaves: List[Tuple[str, str, Path, str]] = []

    def leaf(self, key: str, tree, path: Path, kind: str = "plain"):
        self.leaves.append((key, tree, path, kind))

    def conv(self, dst: str, path: Path, bias: bool = False):
        self.leaf(dst + ".weight", "params", path + ("kernel",), "conv")
        if bias:
            self.leaf(dst + ".bias", "params", path + ("bias",))

    def bn(self, dst: str, path: Path, scale: bool = True):
        if scale:
            self.leaf(dst + ".weight", "params", path + ("scale",))
        else:
            self.leaf(dst + ".weight", None, path + ("bias",), "ones")
        self.leaf(dst + ".bias", "params", path + ("bias",))
        self.leaf(dst + ".running_mean", "batch_stats", path + ("mean",))
        self.leaf(dst + ".running_var", "batch_stats", path + ("var",))
        self.leaf(dst + ".num_batches_tracked", None, (), "zero")

    def prelu(self, dst: str, path: Path):
        self.leaf(dst + ".weight", "params", path + ("alpha",))

    def fc(self, dst: str, path: Path, hw, bias: bool = True):
        """A dense over a C-major flatten of an h x w map (hw = (h, w))."""
        self.leaf(dst + ".weight", "params", path + ("kernel",),
                  "fc%dx%d" % tuple(hw))
        if bias:
            self.leaf(dst + ".bias", "params", path + ("bias",))

    def bn1d_flat(self, dst: str, path: Path, hw):
        """A BatchNorm1d over a C-major flatten of an h x w map: each of
        its vectors in the other order on the flax side."""
        kind = "flat%dx%d" % tuple(hw)
        self.leaf(dst + ".weight", "params", path + ("scale",), kind)
        self.leaf(dst + ".bias", "params", path + ("bias",), kind)
        self.leaf(dst + ".running_mean", "batch_stats", path + ("mean",),
                  kind)
        self.leaf(dst + ".running_var", "batch_stats", path + ("var",),
                  kind)
        self.leaf(dst + ".num_batches_tracked", None, (), "zero")


def _stage(e: _Layout, dst: str, path: Path):
    i = 0
    while e.has(path + (f"block{i}",), f"{dst}.{i}."):
        d, p = f"{dst}.{i}", path + (f"block{i}",)
        e.bn(d + ".bn1", p + ("bn1",))
        e.conv(d + ".conv1", p + ("conv1",))
        e.bn(d + ".bn2", p + ("bn2",))
        e.prelu(d + ".prelu", p + ("prelu",))
        e.conv(d + ".conv2", p + ("conv2",))
        e.bn(d + ".bn3", p + ("bn3",))
        if e.has(p + ("downsample_conv",), d + ".downsample."):
            e.conv(d + ".downsample.0", p + ("downsample_conv",))
            e.bn(d + ".downsample.1", p + ("downsample_bn",))
        i += 1


def _stem_and_stages(e: _Layout, dst: str, path: Path):
    e.conv(dst + ".conv1", path + ("conv1",))
    e.bn(dst + ".bn1", path + ("bn1",))
    e.prelu(dst + ".prelu", path + ("prelu",))
    for li in range(1, 5):
        _stage(e, f"{dst}.layer{li}", path + (f"layer{li}",))
    e.bn(dst + ".bn2", path + ("bn2",))


def _iresnet(e: _Layout, dst: str, path: Path):
    _stem_and_stages(e, dst, path)
    e.fc(dst + ".fc", path + ("fc",), FC_HW)
    e.bn(dst + ".features", path + ("features",), scale=False)


def _lightcnn(e: _Layout, dst: str, path: Path):
    """network_29layers_v2 (`msml_tpu/tools/export_torch.py:188-223`): the
    flax stage1 / stage2 wrap (block{i}..., group), stages 3 and 4 are
    flat (`stage3_block{i}`, `group3`, ...); torch names block1..4,
    group1..4."""

    def mfm(d: str, p: Path):
        e.conv(d + ".filter", p + ("filter",), bias=True)

    def blocks(d: str, p: Path, flax_name):
        i = 0
        while e.has(p + (flax_name(i),), f"{d}.{i}."):
            for ci in (1, 2):
                mfm(f"{d}.{i}.conv{ci}", p + (flax_name(i), f"conv{ci}"))
            i += 1

    def group(d: str, p: Path):
        mfm(d + ".conv_a", p + ("conv_a",))
        mfm(d + ".conv", p + ("conv",))

    mfm(dst + ".conv1", path + ("conv1",))
    for si in (1, 2):
        sp = path + (f"stage{si}",)
        blocks(f"{dst}.block{si}", sp, lambda i: f"block{i}")
        group(f"{dst}.group{si}", sp + ("group",))
    for si in (3, 4):
        blocks(f"{dst}.block{si}", path,
               lambda i, si=si: f"stage{si}_block{i}")
        group(f"{dst}.group{si}", path + (f"group{si}",))
    e.fc(dst + ".fc", path + ("fc",), LIGHT_FC_HW)


def _frb(e: _Layout, dst: str, path: Path, what: str):
    """The iResNet or the LightCNN trunk at `path`, whichever is there."""
    key = dst + ".conv1."
    if e.has(path + ("conv1", "kernel"), key + "weight"):
        _iresnet(e, dst, path)
    elif e.has(path + ("conv1", "filter"), key + "filter."):
        _lightcnn(e, dst, path)
    else:
        raise NotImplementedError(f"unrecognised {what} parameter layout")


def _fm(e: _Layout, dst: str, path: Path):
    if not e.has(path + ("same_conv",), dst + ".same_conv."):
        return  # FMNone: no parameters either side
    e.conv(dst + ".same_conv", path + ("same_conv",))
    i = 0
    while e.has(path + (f"res{i}",), f"{dst}.res_block.{i}."):
        d, p = f"{dst}.res_block.{i}", path + (f"res{i}",)
        for ci in (1, 2, 3):
            e.conv(f"{d}.conv{ci}", p + (f"conv{ci}",))
            e.bn(f"{d}.bn{ci}", p + (f"bn{ci}",))
            e.prelu(f"{d}.prelu{ci}", p + (f"prelu{ci}",))
        i += 1
    if e.has(path + ("conv_m",), dst + ".conv_m."):
        e.conv(dst + ".conv_m.0", path + ("conv_m",), bias=True)
        e.bn(dst + ".conv_m.1", path + ("conv_m_bn",))
    for tower in ("conv1", "conv2"):
        if e.has(path + (tower,), f"{dst}.{tower}."):
            for j, base in enumerate((0, 3)):
                e.conv(f"{dst}.{tower}.{base}", path + (tower, f"conv{j}"),
                       bias=True)
                e.bn(f"{dst}.{tower}.{base + 1}", path + (tower, f"bn{j}"))
                e.prelu(f"{dst}.{tower}.{base + 2}",
                        path + (tower, f"prelu{j}"))


def _decoder(e: _Layout, dst: str, path: Path):
    for s in range(3):
        e.conv(f"{dst}.conv_in{s}", path + (f"conv_in{s}",), bias=True)
        for r in "ab":
            for ci in (0, 1):
                e.conv(f"{dst}.res{s}{r}.conv{ci}",
                       path + (f"res{s}{r}", f"conv{ci}"), bias=True)
        e.conv(f"{dst}.deconv{s}", path + (f"deconv{s}",), bias=True)
    e.conv(f"{dst}.deconv_out", path + ("deconv_out",), bias=True)


def _unet(e: _Layout, dst: str, path: Path):
    _stem_and_stages(e, dst, path)
    for gi in range(1, 6):
        for leg in ("l1", "l2", "r1", "r2"):
            e.conv(f"{dst}.gcm{gi}.conv_{leg}",
                   path + (f"gcm{gi}", f"conv_{leg}"), bias=True)
    for di in range(1, 6):
        e.conv(f"{dst}.deconv{di}", path + (f"deconv{di}",))


def _walk(e: _Layout) -> _Layout:
    _frb(e, "frb", ("frb",), "FRB")
    if e.has(("frb", "decoder"), "frb.decoder."):
        _decoder(e, "frb.decoder", ("frb", "decoder"))
    for i in range(4):
        _fm(e, f"frb.fm_ops.{i}", (f"fm_op{i}",))
    if e.has(("peer",), "frb.peer."):
        _frb(e, "frb.peer", ("peer",), "peer")
    if e.has(("osb",), "osb."):
        _unet(e, "osb", ("osb",))
    for name in ("weight", "bias"):
        if e.has(("classification", name), f"classification.{name}"):
            e.leaf(f"classification.{name}", "params",
                   ("classification", name))
    return e


def _sphere(e: _Layout, hw):
    """Sphere (`msml_tpu/tools/import_torch.py:257-277`): flax
    `layer{n}_conv`, `layer{n}_prelu`, `layer{n}_block{b}` -> torch
    `layer{n}.0`, `layer{n}.1`, `layer{n}.{2 + b}`."""
    for li in range(1, 5):
        e.conv(f"layer{li}.0", (f"layer{li}_conv",), bias=True)
        e.prelu(f"layer{li}.1", (f"layer{li}_prelu",))
        b = 0
        while e.has((f"layer{li}_block{b}",), f"layer{li}.{2 + b}."):
            d, p = f"layer{li}.{2 + b}", (f"layer{li}_block{b}",)
            for ci in (1, 2):
                e.conv(f"{d}.conv{ci}", p + (f"conv{ci}",))
                e.prelu(f"{d}.prelu{ci}", p + (f"prelu{ci}",))
            b += 1
    e.fc("fc", ("fc",), hw)


def _resnet(e: _Layout, hw):
    """The BasicBlock ResNet: flax `layer{n}_block{b}` -> torchvision's
    `layer{n}.{b}`."""
    e.conv("conv1", ("conv1",))
    e.bn("bn1", ("bn1",))
    for li in range(1, 5):
        b = 0
        while e.has((f"layer{li}_block{b}",), f"layer{li}.{b}."):
            d, p = f"layer{li}.{b}", (f"layer{li}_block{b}",)
            for ci in (1, 2):
                e.conv(f"{d}.conv{ci}", p + (f"conv{ci}",))
                e.bn(f"{d}.bn{ci}", p + (f"bn{ci}",))
            if e.has(p + ("downsample_conv",), d + ".downsample."):
                e.conv(d + ".downsample.0", p + ("downsample_conv",))
                e.bn(d + ".downsample.1", p + ("downsample_bn",))
            b += 1
    e.bn("bn2", ("bn2",))
    e.fc("fc", ("fc",), hw)


def _lresnet_occ(e: _Layout, hw, root: Path = ()):
    """LResNetOcc (`msml_tpu/tools/import_torch.py:287-347`) under `root`
    (`("model",)` for From2021): `prelu1` in the blocks, the Sequential
    indices of `mask`, `regress` and `fc`, and the heads' BN1d and linear
    rows over the C-major flatten."""
    e.conv("conv1", root + ("conv1",))
    e.bn("bn1", root + ("bn1",))
    e.prelu("prelu1", root + ("prelu1",))
    for li in range(1, 5):
        b = 0
        while e.has(root + (f"layer{li}_block{b}",), f"layer{li}.{b}."):
            d, p = f"layer{li}.{b}", root + (f"layer{li}_block{b}",)
            e.bn(d + ".bn1", p + ("bn1",))
            e.conv(d + ".conv1", p + ("conv1",))
            e.bn(d + ".bn2", p + ("bn2",))
            e.prelu(d + ".prelu1", p + ("prelu",))
            e.conv(d + ".conv2", p + ("conv2",))
            e.bn(d + ".bn3", p + ("bn3",))
            if e.has(p + ("downsample_conv",), d + ".downsample."):
                e.conv(d + ".downsample.0", p + ("downsample_conv",))
                e.bn(d + ".downsample.1", p + ("downsample_bn",))
            b += 1
    for leg in ("P5_1", "P5_2", "P4_1", "P4_2", "P3_1", "P3_2", "P6", "P7_2"):
        e.conv(f"fpn.{leg}", root + ("fpn", leg), bias=True)
    e.conv("mask.0", root + ("mask_conv0",))
    e.prelu("mask.1", root + ("mask_prelu0",))
    e.bn("mask.2", root + ("mask_bn0",))
    e.conv("mask.3", root + ("mask_conv1",))
    e.bn1d_flat("regress.0", root + ("regress_bn0",), hw)
    e.fc("regress.2", root + ("regress_fc",), hw, bias=False)
    e.bn("regress.3", root + ("regress_bn1",))
    e.bn1d_flat("fc.0", root + ("fc_bn0",), hw)
    e.fc("fc.2", root + ("fc_fc",), hw)
    e.bn("fc.3", root + ("fc_bn1",))


# network -> (walk(layout, (h, w) of the last map), default input (h, w))
NETWORKS = {
    "msml": (lambda e, hw: _walk(e), None),
    "sphere": (_sphere, (112, 96)),
    "resnet": (_resnet, (112, 112)),
    "lresnet_occ": (_lresnet_occ, (112, 96)),
    "from2021": (lambda e, hw: _lresnet_occ(e, hw, ("model",)), (112, 96)),
}


def _layout(e: _Layout, network: str, input_size) -> _Layout:
    if network not in NETWORKS:
        raise ValueError(f"unknown network {network!r} "
                         f"({', '.join(NETWORKS)})")
    walk, default = NETWORKS[network]
    walk(e, None if default is None else final_map(input_size or default))
    return e


def _hw(kind: str) -> Tuple[int, int]:
    """(h, w) of an "fc{h}x{w}" or "flat{h}x{w}" leaf kind."""
    h, w = kind.removeprefix("flat").removeprefix("fc").split("x")
    return int(h), int(w)


class _Emitter(_Layout):
    """The walk over flax trees; `out` is the state dict it gives, as
    numpy arrays."""

    def __init__(self, params: Dict, batch_stats: Dict):
        super().__init__(lambda path, _: _has(params, path))
        self.trees = {"params": params, "batch_stats": batch_stats}

    @property
    def out(self) -> Dict[str, np.ndarray]:
        out = {}
        for key, tree, path, kind in self.leaves:
            if kind == "zero":
                out[key] = np.asarray(0, np.int64)
                continue
            v = _get(self.trees[tree or "params"], path)
            if kind == "conv":  # HWIO -> OIHW; transposed (kh,kw,O,I) -> IO
                v = np.transpose(v, (3, 2, 0, 1))
            elif kind.startswith("fc"):  # HWC rows -> C-major columns
                h, w = _hw(kind)
                c, out_dim = v.shape[0] // (h * w), v.shape[1]
                v = np.transpose(v.reshape(h, w, c, out_dim),
                                 (3, 2, 0, 1)).reshape(out_dim, -1)
            elif kind.startswith("flat"):  # an HWC vector -> C-major
                h, w = _hw(kind)
                v = np.transpose(v.reshape(h, w, -1), (2, 0, 1)).reshape(-1)
            elif kind == "ones":
                v = np.ones_like(v)
            out[key] = v
        return out


def state_dict_from_jax(params: Dict, batch_stats: Dict,
                        network: str = "msml", input_size=None
                        ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) flax trees -> the port's state dict of
    `network` ("msml", or a baseline: "sphere", "resnet", "lresnet_occ",
    "from2021"; a baseline's fc reads the last map of `input_size` (h, w),
    by default the one it is evaluated at)."""
    return {k: torch.from_numpy(np.array(
        v, np.int64 if v.dtype == np.int64 else np.float32, order="C"))
        for k, v in _layout(_Emitter(params, batch_stats), network,
                            input_size).out.items()}


def jax_from_state_dict(state_dict, network: str = "msml",
                        input_size=None) -> Tuple[Dict, Dict]:
    """The port's state dict of `network` (tensors or arrays, torch names)
    -> (params, batch_stats) flax trees of float32 numpy arrays: what
    `msml_tpu.tools.import_torch` makes of it (`import_msml_checkpoint`,
    `import_sphere`, `import_from2021`). `num_batches_tracked` and the
    `features` scale have no flax leaf and are dropped."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in state_dict.items()}
    trees = {"params": {}, "batch_stats": {}}
    layout = _layout(_Layout(
        lambda _, prefix: any(k.startswith(prefix) for k in sd)), network,
        input_size)
    for key, tree, path, kind in layout.leaves:
        if tree is None:
            continue
        v = sd[key]
        if kind == "conv":
            v = np.transpose(v, (2, 3, 1, 0))
        elif kind.startswith("fc"):
            h, w = _hw(kind)
            out_dim, c = v.shape[0], v.shape[1] // (h * w)
            v = np.transpose(v.reshape(out_dim, c, h, w),
                             (2, 3, 1, 0)).reshape(-1, out_dim)
        elif kind.startswith("flat"):
            h, w = _hw(kind)
            v = np.transpose(v.reshape(-1, h, w), (1, 2, 0)).reshape(-1)
        _set(trees[tree], path, np.asarray(v, np.float32))
    return trees["params"], trees["batch_stats"]


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': leaf} (flax `traverse_util.flatten_dict`
    with `/`-joined keys), each key led by `prefix/` if one is given."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """The inverse of `flatten` (without a prefix)."""
    tree: Dict = {}
    for key, v in flat.items():
        _set(tree, tuple(key.split("/")), v)
    return tree
