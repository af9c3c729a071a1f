"""The port's serving surface (`msml_torch.cli.serve`, `cli.embed`) against
the JAX package's (`msml_tpu.cli.serve`, `cli.embed`) on the CPU.

The batching, bucket and metrics layers run in both packages with the JAX
tests' deterministic fake forward (`tests/test_serve.py::_FakeRaw`) and
must agree exactly. Then one set of weights, drawn with numpy in the flax
layout (arc18_msml at full width, one block per iResNet stage, float32), is
served three ways: by the JAX package's weight-folder runner (its orbax
restore replaced by these weights), and, after `msml_tpu.tools.export_torch`
wrote them as `backbone.pth`, by the port's weight-folder runner and by the
port's `tools.export_serving` artifact, each over HTTP. Embeddings are
l2-normalized; the port and JAX sum in another order, hence a tolerance
(`JAX_ATOL`); the artifact and the port's live model run the same ops and
must agree to `ARTIFACT_ATOL`.
"""

import contextlib
import importlib
import io
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from tests.test_serve import _FakeRaw, _get, _post

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["msml_tpu.cli.serve", "msml_torch.cli.serve"]
# l2-normalized f32 features (unit vectors of 512): the port sums in another
# order than XLA (up to 7e-7 apart here), the artifact runs the live
# model's ops (0 apart here)
JAX_ATOL = 1e-5
ARTIFACT_ATOL = 1e-6


@pytest.fixture(params=PACKAGES, ids=["jax", "torch"])
def serve(request):
    return importlib.import_module(request.param)


def fake_runner(serve, **kw):
    kw.setdefault("flip", False)
    kw.setdefault("l2_norm", False)
    return serve.ModelRunner(_FakeRaw(), out_size=(16, 16), is_gray=False,
                             use_norm=True, meta={"network": "fake"}, **kw)


@contextlib.contextmanager
def serving(serve, runner, **kw):
    """-> base URL of a live server of `serve`'s build_server."""
    kw.setdefault("max_batch", 8)
    kw.setdefault("window_ms", 1.0)
    httpd, batcher = serve.build_server(runner, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        if hasattr(batcher, "close"):
            batcher.close()


def npy(xs) -> bytes:
    buf = io.BytesIO()
    np.save(buf, xs)
    return buf.getvalue()


def metrics(base) -> dict:
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        assert "text/plain" in r.headers["Content-Type"]
        text = r.read().decode()
    return dict(line.rsplit(" ", 1) for line in text.splitlines()
                if line and not line.startswith("#"))


# ------------------------------------------------- batching, both packages

@pytest.mark.parametrize("max_batch", [1, 5, 24, 32])
def test_bucket_ladder_equals_jax(max_batch):
    from msml_tpu.cli.serve import _buckets as jax_buckets
    from msml_torch.cli.serve import _buckets

    assert _buckets(max_batch) == jax_buckets(max_batch)
    assert _buckets(32) == [1, 2, 4, 8, 16, 32]


def test_batcher_pads_to_buckets_and_slices_back(serve):
    raw = _FakeRaw()
    b = serve.Batcher(raw, max_batch=8, window_ms=1.0)
    xs = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32)
    y = b.run_padded(xs)
    np.testing.assert_allclose(y, xs.mean(axis=(1, 2)), rtol=1e-6)
    assert raw.batch_sizes[-1] == 4  # padded 3 -> bucket 4
    xs = np.random.RandomState(1).rand(19, 16, 16, 3).astype(np.float32)
    y = b.run_padded(xs)
    assert y.shape == (19, 3)
    np.testing.assert_allclose(y, xs.mean(axis=(1, 2)), rtol=1e-6)
    assert raw.batch_sizes[-3:] == [8, 8, 4]  # 8 + 8 + pad(3 -> 4)


def test_batcher_gathers_concurrent_submits(serve):
    raw = _FakeRaw()
    b = serve.Batcher(raw, max_batch=16, window_ms=50.0)
    xs = np.random.RandomState(2).rand(6, 4, 4, 3).astype(np.float32)
    outs = [None] * 6

    def work(i):
        outs[i] = b.submit(xs[i])

    ts = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    for i in range(6):
        np.testing.assert_allclose(outs[i], xs[i].mean(axis=(0, 1)),
                                   rtol=1e-6)
    assert len(raw.batch_sizes) < 6
    assert all(s in (1, 2, 4, 8, 16) for s in raw.batch_sizes)


def test_batcher_propagates_inference_errors(serve):
    def boom(x):
        raise RuntimeError("device on fire")

    b = serve.Batcher(boom, max_batch=4, window_ms=1.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        b.submit(np.zeros((4, 4, 3), np.float32))
    b._infer = lambda x: x.mean(axis=(1, 2))
    y = b.submit(np.ones((4, 4, 3), np.float32))
    np.testing.assert_allclose(y, [1.0, 1.0, 1.0], rtol=1e-6)


def test_batcher_close_answers_queued_requests_and_ends():
    from msml_torch.cli.serve import Batcher

    raw = _FakeRaw()
    b = Batcher(raw, max_batch=4, window_ms=20.0)
    xs = np.random.RandomState(3).rand(3, 4, 4, 3).astype(np.float32)
    outs = {}
    ts = [threading.Thread(target=lambda i=i: outs.update({i: b.submit(
        xs[i])})) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    b.close()
    assert not b._t.is_alive()
    for i in range(3):
        np.testing.assert_allclose(outs[i], xs[i].mean(axis=(0, 1)),
                                   rtol=1e-6)


def test_metrics_render_equals_jax():
    """The same observations render the same Prometheus text."""
    from msml_tpu.cli.serve import Metrics as JaxMetrics
    from msml_torch.cli.serve import Metrics

    rs = np.random.RandomState(4)
    jm, tm = JaxMetrics(queue_depth=lambda: 3), Metrics(queue_depth=lambda: 3)
    for _ in range(50):
        s, err, n = float(rs.exponential(0.05)), rs.rand() < 0.2, \
            int(rs.randint(1, 33))
        for m in (jm, tm):
            m.observe_request(s, error=bool(err))
            m.observe_batch(n)
    assert tm.render() == jm.render()


def test_metrics_endpoint_counts(serve):
    runner = fake_runner(serve)
    with serving(serve, runner) as base:
        xs = np.random.RandomState(1).rand(3, 16, 16, 3).astype(np.float32)
        for _ in range(2):
            assert _post(base + "/embed_batch", npy(xs))[0] == 200
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/embed_batch", b"junk")
        assert err.value.code == 400
        m = metrics(base)
    assert float(m["msml_requests_total"]) == 3
    assert float(m["msml_request_errors_total"]) == 1
    assert float(m["msml_device_batches_total"]) == 2
    assert float(m["msml_images_total"]) == 6
    assert float(m['msml_request_latency_seconds_bucket{le="+Inf"}']) == 3


def test_flip_sum_and_l2_policy(serve):
    runner = fake_runner(serve, flip=True, l2_norm=True)
    xs = np.random.RandomState(5).rand(2, 16, 16, 3).astype(np.float32)
    raw = xs.mean(axis=(1, 2)) + xs[:, :, ::-1, :].mean(axis=(1, 2))
    want = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    np.testing.assert_allclose(runner.infer(xs), want, rtol=1e-5)


# ------------------------------------------------ HTTP: port against JAX

def _body(kind: str):
    """A request of each kind: an image of another size than the model's
    16 x 16 (so the server resizes it) as PNG or PPM, or a .npy batch."""
    from PIL import Image

    from msml_torch.data.bin_loader import ppm_encode

    rs = np.random.RandomState(6)
    if kind == "npy":
        return "/embed_batch", npy(rs.rand(5, 16, 16, 3).astype(np.float32))
    img = rs.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    if kind == "ppm":
        return "/embed", ppm_encode(img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "/embed", buf.getvalue()


@pytest.mark.parametrize("kind", ["png", "ppm", "npy"])
def test_http_answers_equal_jax(kind):
    """PNG (Pillow), binary PPM (the port's reader; Pillow in JAX) and
    .npy bodies get the same answers from both servers; /healthz carries
    JAX's keys; a malformed batch is a 400 in both."""
    jserve = importlib.import_module("msml_tpu.cli.serve")
    tserve = importlib.import_module("msml_torch.cli.serve")
    path, body = _body(kind)
    answers, health = [], []
    for serve in (jserve, tserve):
        with serving(serve, fake_runner(serve, flip=True)) as base:
            code, out = _post(base + path, body)
            assert code == 200
            answers.append(out)
            health.append(_get(base + "/healthz")[1])
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + "/embed_batch",
                      npy(np.zeros((2, 8, 8, 3), np.float32)))
            assert err.value.code == 400
            assert "expected" in json.loads(err.value.read())["error"]
    assert health[0] == health[1]
    key = "embeddings" if kind == "npy" else "embedding"
    np.testing.assert_array_equal(np.asarray(answers[1][key]),
                                  np.asarray(answers[0][key]))


# -------------------------------------------------------- entry points

@pytest.mark.parametrize("argv", [
    ["--artifact", "m.pt2", "--quant", "int8"],
    ["--artifact", "m.pt2", "--spatial", "2"],
    ["--weight_folder", "w", "--quant", "int8"],
    ["--weight_folder", "w", "--spatial", "2"]])
def test_quant_and_spatial_are_refused(argv):
    from msml_torch.cli import serve

    with pytest.raises(SystemExit, match="not ported yet"):
        serve.main(serve.parse_args(argv + ["--no-warmup", "--device",
                                            "cpu"]))


def test_cuda_is_the_default_device(monkeypatch, tmp_path):
    from msml_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.parse_args(["--weight_folder", "w"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(serve.parse_args(["--weight_folder", str(tmp_path),
                                     "--no-warmup"]))


# --------------------------------------- one set of weights, three runners

def write_jax_weight_folder(folder):
    """arc18_msml (one block per iResNet stage, float32) with numpy-drawn
    flax variables, written as the JAX package's exporter writes a weight
    folder (`config.yaml` + `backbone.pth`). Call with the shallow depth
    patched in both packages. -> (JAX config, flax model, variables)."""
    from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_tpu.tools.export_torch import export_msml_state_dict
    from tests.test_torch_nn import arc18_configs, random_variables

    jcfg, _ = arc18_configs()
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    x = np.zeros((1, 112, 112, 3), np.float32)
    v = random_variables(jmodel, x, train=False)
    sd = export_msml_state_dict(v["params"], v["batch_stats"])
    os.makedirs(folder, exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
               os.path.join(folder, "backbone.pth"))
    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["fp16"] = False
    with open(os.path.join(folder, "config.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    return jcfg, jmodel, v


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """-> namespace(folder, jax: the JAX package's load_weight_folder
    stand-in, artifact: the port's export of the folder)."""
    from msml_tpu.core.mesh import make_mesh
    from msml_tpu.nn import iresnet as jiresnet
    from msml_torch.nn import iresnet as tiresnet
    from msml_torch.tools import export_serving

    root = tmp_path_factory.mktemp("weights")
    folder = str(root / "arc18_msml_1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(tiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        jcfg, jmodel, v = write_jax_weight_folder(folder)
        state = types.SimpleNamespace(params=v["params"],
                                      batch_stats=v["batch_stats"])

        def jax_load_weight_folder(weight_folder, mesh=None, **_):
            assert weight_folder == folder
            return jcfg, jmodel, state, mesh or make_mesh(), False

        artifact = str(root / "model.pt2")
        export_serving.main(export_serving.parse_args(
            ["--weight_folder", folder, "--out", artifact, "--device",
             "cpu"]))
        yield types.SimpleNamespace(folder=folder, artifact=artifact,
                                    jax_load=jax_load_weight_folder)


@pytest.fixture
def jax_restores_these_weights(weights, monkeypatch):
    from msml_tpu.core import tpu_flags
    from msml_tpu.core import weight_folder as jax_wf

    monkeypatch.setattr(jax_wf, "load_weight_folder", weights.jax_load)
    monkeypatch.setattr(tpu_flags, "apply_tuned_flags", lambda: "")


def test_weight_folder_and_artifact_servers_equal_jax(
        weights, jax_restores_these_weights):
    """/embed_batch of 3 images (bucket 4), flip-summed and l2-normalized:
    the port's weight-folder server and artifact server against the JAX
    package's weight-folder server on the same weights."""
    from msml_tpu.cli import serve as jserve
    from msml_torch.cli import serve as tserve

    xs = np.random.RandomState(7).uniform(-1, 1, (3, 112, 112, 3)).astype(
        np.float32)
    runners = [(jserve, jserve.runner_from_weight_folder(weights.folder)),
               (tserve, tserve.runner_from_weight_folder(weights.folder,
                                                         "cpu")),
               (tserve, tserve.runner_from_artifact(weights.artifact,
                                                    "cpu"))]
    got, health = [], []
    for serve, runner in runners:
        with serving(serve, runner, max_batch=4) as base:
            code, out = _post(base + "/embed_batch", npy(xs), timeout=600)
            assert code == 200
            got.append(np.asarray(out["embeddings"]))
            health.append(_get(base + "/healthz")[1])
    want, folder, artifact = got
    assert want.shape == (3, 512)
    np.testing.assert_allclose(folder, want, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(artifact, folder, atol=ARTIFACT_ATOL, rtol=0)
    assert health[1] == health[0]
    assert health[2] == dict(health[1], source=weights.artifact)


def test_embed_image_server_equals_jax(weights, jax_restores_these_weights):
    """/embed with PNG and PPM bodies of a 120 x 100 image (resized by the
    server) through the port's server equals the JAX server's answer."""
    from PIL import Image

    from msml_tpu.cli import serve as jserve
    from msml_torch.cli import serve as tserve
    from msml_torch.data.bin_loader import ppm_encode

    img = np.random.RandomState(8).randint(0, 256, (100, 120, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    bodies = [buf.getvalue(), ppm_encode(img)]
    answers = []
    for serve, runner in (
            (jserve, jserve.runner_from_weight_folder(weights.folder)),
            (tserve, tserve.runner_from_weight_folder(weights.folder,
                                                      "cpu"))):
        with serving(serve, runner, max_batch=4) as base:
            answers.append([np.asarray(_post(base + "/embed", b,
                                             timeout=600)[1]["embedding"])
                            for b in bodies])
    (j_png, j_ppm), (t_png, t_ppm) = answers
    np.testing.assert_array_equal(j_ppm, j_png)
    np.testing.assert_array_equal(t_ppm, t_png)
    np.testing.assert_allclose(t_png, j_png, atol=JAX_ATOL, rtol=0)


def test_cli_embed_equals_jax(weights, jax_restores_these_weights, tmp_path):
    """`cli.embed` over a folder of 5 PNG images (one of another size, one
    in a subfolder): the same names file, and features within JAX_ATOL."""
    from PIL import Image

    from msml_tpu.cli import embed as jembed
    from msml_torch.cli import embed as tembed

    src = tmp_path / "faces"
    (src / "sub").mkdir(parents=True)
    rs = np.random.RandomState(9)
    for i, name in enumerate(["a.png", "b.png", "c.png", "sub/d.png",
                              "e.png"]):
        shape = (100, 120, 3) if i == 2 else (112, 112, 3)
        Image.fromarray(rs.randint(0, 256, shape).astype(np.uint8)).save(
            src / name)
    (src / "notes.txt").write_text("not an image")
    outs = []
    for pkg, extra in ((jembed, []), (tembed, ["--device", "cpu"])):
        out = str(tmp_path / f"{pkg.__name__}.npy")
        feats, names = pkg.main(pkg.parse_args(
            ["--weight_folder", weights.folder, "--src", str(src), "--out",
             out, "--batch-size", "4"] + extra))
        with open(out + ".names.txt") as f:
            outs.append((np.load(out), f.read()))
        np.testing.assert_array_equal(outs[-1][0], feats)
    (jf, jnames), (tf, tnames) = outs
    assert tnames == jnames == "a.png\nb.png\nc.png\ne.png\nsub/d.png\n"
    np.testing.assert_allclose(tf, jf, atol=JAX_ATOL, rtol=0)


def test_forward_keeps_eval_mode_across_threads(weights):
    """The batcher's thread and handlers' threads run the forward side by
    side: each in an inference mode of its own that ends with the call,
    the model left in eval mode, the same features in every thread."""
    from msml_torch.cli.serve import numpy_forward
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.tools.export_serving import EvalForward

    _, model = load_weight_folder(weights.folder, device="cpu")
    raw = numpy_forward(EvalForward(model), torch.device("cpu"))
    xs = np.random.RandomState(10).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    want = raw(xs)
    outs, errors = [], []

    def work():
        try:
            outs.append(raw(xs))
            assert not torch.is_inference_mode_enabled()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=work) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
        assert not t.is_alive()
    assert not errors and len(outs) == 3
    for out in outs:
        np.testing.assert_array_equal(out, want)
    assert not any(m.training for m in model.modules())
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


@pytest.mark.parametrize("source", ["weight_folder", "artifact"])
def test_main_serves_all_four_endpoints(weights, monkeypatch, source):
    """`python -m msml_torch.cli.serve --<source> ... --device cpu` as a user
    starts it (warm-up included): /healthz, /metrics, /embed (PPM) and
    /embed_batch answer, and /embed_batch equals a runner's own answer."""
    from msml_torch.cli import serve as tserve
    from msml_torch.data.bin_loader import ppm_encode

    started = []
    build_server = tserve.build_server

    def recorded(*a, **k):
        started.append(build_server(*a, **k))
        return started[-1]

    monkeypatch.setattr(tserve, "build_server", recorded)
    path = weights.folder if source == "weight_folder" else weights.artifact
    args = tserve.parse_args([f"--{source}", path, "--device", "cpu",
                              "--port", "0", "--max-batch", "2"])
    thread = threading.Thread(target=tserve.main, args=(args,), daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if started or not thread.is_alive():
                break
            thread.join(0.5)
        assert started, "the server did not start"
        httpd, batcher = started[0]
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _get(base + "/healthz")[1]["source"] == path
        img = np.random.RandomState(11).randint(0, 256, (112, 112, 3))
        code, one = _post(base + "/embed", ppm_encode(img.astype(np.uint8)),
                          timeout=600)
        assert code == 200 and len(one["embedding"]) == 512
        xs = np.random.RandomState(12).uniform(-1, 1, (3, 112, 112, 3)) \
            .astype(np.float32)
        code, out = _post(base + "/embed_batch", npy(xs), timeout=600)
        m = metrics(base)
    finally:
        if started:
            started[0][0].shutdown()
        thread.join(60)
    assert not thread.is_alive()
    assert code == 200
    assert float(m["msml_requests_total"]) == 2
    assert float(m["msml_request_errors_total"]) == 0
    want = tserve.runner_from_weight_folder(weights.folder, "cpu").infer(xs)
    np.testing.assert_allclose(np.asarray(out["embeddings"]), want,
                               atol=ARTIFACT_ATOL, rtol=0)
