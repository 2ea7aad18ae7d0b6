"""Export and serving of the port (``tools/export_torch.py``,
``tools/serve_torch.py``) against the live ``Tester``, on the CPU.

A tiny HRNet (``torch_port_helpers.tiny_hrnet``: the hrnet18 topology at
one block a stage and widths 8-64, so that ``torch.export`` traces it in
seconds) with the preset's seeded init:

* ``--scope ss --dynamic-batch``: the loaded artifact at batch 1 and 3
  against ``Tester.ss_test``; ``--scope ms`` (one scale, 0.5, so that the
  graph holds the resize down and back and the flip at half the tracing
  time of two) at batch 2 against ``Tester.ms_test``; both within 1e-5 abs (the same
  fp32 ops; only the graph's execution differs), and their metadata;
* ``--load`` through the CLI (the ms artifact's check);
* an HTTP round trip through ``serve_torch``: ``/healthz``, ``/segment`` at
  the artifact's size and at another (the port's bicubic resize first), a
  bad body (400) and an unknown path (404);
* refusals: ``--weights sidecar`` and the default device ``cuda`` without
  CUDA; a ``network.pallas_conv`` net, once refused, exports with K2's
  custom op (``contrastiveseg::conv3x3``) in its graph (its round trip
  against the Tester, in bf16 and in a fresh process, is in
  ``tests/test_torch_port_bf16_k2.py``).
"""

from __future__ import annotations

import io
import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.engine import tester as ptester
from tools import export_torch, serve_torch
from tools.train_torch import build_config

from torch_port_helpers import one_torch_thread, tiny_hrnet

HW = (32, 48)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _tiny_hrnet():
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        tiny_hrnet(mp)
        yield


def _cfg(*extra):
    return build_config("smoke_hrnet_w18", None, ["test.scale_search=[0.5]", *extra])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    cfg = _cfg()
    metas = {
        "ss": export_torch.export_artifact(cfg, str(root / "ss"), "ss", HW, 1, True,
                                           device="cpu"),
        "ms": export_torch.export_artifact(cfg, str(root / "ms"), "ms", HW, 2, False,
                                           device="cpu"),
    }
    live = ptester.Tester(cfg, export_torch.load_model(cfg, None, "cpu"))
    return {"root": root, "metas": metas, "live": live,
            "runner": serve_torch.ArtifactRunner(str(root / "ss"))}


def _images(b, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((b, *HW, 3)).astype(np.float32))


def test_ss_dynamic_batch_matches_the_tester(artifacts):
    module = artifacts["runner"].module
    for b in (1, 3):
        x = _images(b, seed=b)
        with torch.no_grad():
            got = module(x)
        assert got.shape == (b, *HW, 5)
        np.testing.assert_allclose(got.numpy(), artifacts["live"].ss_test(x).numpy(), atol=ATOL)
    meta = artifacts["metas"]["ss"]
    assert meta["input"]["shape"] == ["b", *HW, 3] and meta["device"] == "cpu"
    assert meta["num_classes"] == 5 and meta["scope"] == "ss" and meta["weights"] == "baked"
    assert meta["normalize"] == {"div_value": 255.0, "mean": [0.485, 0.456, 0.406],
                                 "std": [0.229, 0.224, 0.225]}


def test_ms_through_load_matches_the_tester(artifacts, monkeypatch, capsys):
    """``--load`` of the ms artifact through the CLI: its logits against
    ``Tester.ms_test`` on the CLI's input."""
    runs, run = [], export_torch.run_artifact
    monkeypatch.setattr(export_torch, "run_artifact", lambda *a: runs.append(run(*a)) or runs[-1])
    monkeypatch.setattr(sys, "argv", ["export_torch.py", "--load", str(artifacts["root"] / "ms")])
    export_torch.main()
    assert f"input (2, {HW[0]}, {HW[1]}, 3) -> logits (2, {HW[0]}, {HW[1]}, 5)" in (
        capsys.readouterr().out)
    ((x, got),) = runs
    want = artifacts["live"].ms_test(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    meta = artifacts["metas"]["ms"]
    assert meta["input"]["shape"] == [2, *HW, 3] and meta["scale_search"] == [0.5]
    with open(artifacts["root"] / "ms.json") as f:
        assert json.load(f) == meta


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_http_round_trip(artifacts):
    runner = artifacts["runner"]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_torch.make_handler(runner))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    live = artifacts["live"]

    def want(img):
        x = torch.from_numpy(runner.preprocess(img))
        return live.ss_test(x)[0].argmax(-1).to(torch.int32).numpy()

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.load(r)
        assert health["status"] == "ok" and health["input"]["shape"] == ["b", *HW, 3]
        rng = np.random.default_rng(9)
        img = rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
        got = _post(url + "/segment", _npy(img))
        assert got.dtype == np.int32 and got.shape == HW
        np.testing.assert_array_equal(got, want(img))
        big = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
        resized = native.resize_bicubic_u8(big, (HW[1], HW[0]))
        assert resized is not None and resized.shape == (*HW, 3)
        np.testing.assert_array_equal(_post(url + "/segment", _npy(big)), want(resized))
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/segment", b"not a npy")
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/segment", _npy(np.zeros((4, 4), np.uint8)))
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/nothing", timeout=60)
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    assert not server.is_alive()


def test_refusals(tmp_path, monkeypatch):
    cfg = _cfg()
    export_torch.export_artifact(cfg.updated("network.pallas_conv", True),
                                 str(tmp_path / "k2"), device="cpu")
    graph = str(torch.export.load(tmp_path / "k2.pt2").graph)
    assert "contrastiveseg.conv3x3" in graph
    for f in tmp_path.iterdir():
        f.unlink()
    with pytest.raises(NotImplementedError, match="ROADMAP 6"):
        export_torch.export_artifact(cfg, str(tmp_path / "a"), device="cpu", weights="sidecar")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_torch.export_artifact(cfg, str(tmp_path / "a"))  # the default device
    assert not list(tmp_path.iterdir())
