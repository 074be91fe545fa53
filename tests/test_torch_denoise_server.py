"""The port's denoise server (merlot_tpu_torch.tools.denoise_server) on the
CPU: ``Denoiser.run_batch`` against the JAX package's on the same weights
(moved through a .npz of flax-path leaves), the HTTP roundtrip, dynamic
batching and ``/stats`` as tests/test_grover.py drives them, a
pipeline-parallel checkpoint, and the refusals (no card, ``tp > 1``).

Tolerances: with top_p tiny, sampling is the argmax, so the tokens must be
identical; the probs (fp32) within 1e-5 abs.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.models import grover as jg
from merlot_tpu.tools import denoise_server as jds
from merlot_tpu_torch.tools import denoise_server as tds
from torch_port_helpers import flat_params

TINY = {"vocab_size": 50270, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 128}


@pytest.fixture
def cfg_path(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _save_npz(path, params):
    np.savez(path, **{f"params/{k}": v for k, v in flat_params(params).items()})
    return str(path)


@pytest.mark.parametrize("window_ms", [0.0, 15.0])
def test_run_batch_matches_jax(cfg_path, tmp_path, window_ms):
    """Three contexts of different lengths (batch padded to 4, an all-pad
    row), exact prefill (engine off) or the engine's bucketed prefix."""
    kw = dict(max_len=48, top_p=1e-6, max_ctx=32, batch_window_ms=window_ms)
    jd = jds.Denoiser(cfg_path, None, **kw)
    td = tds.Denoiser(cfg_path, _save_npz(tmp_path / "w.npz", jd.params["params"]),
                      device="cpu", **kw)
    rng = np.random.default_rng(0)
    ctxs = [list(rng.integers(10, 50000, n)) for n in (11, 7, 20)]
    eos = jd.tok.end_article
    for (jt, jp), (tt, tp) in zip(jd.run_batch(ctxs, eos), td.run_batch(ctxs, eos)):
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-5)
    text = "so today were gonna make pasta"
    if window_ms == 0.0:
        j_text, j_ppl = jd.denoise(text)
        t_text, t_ppl = td.denoise(text)
        assert t_text == j_text
        np.testing.assert_allclose(t_ppl, j_ppl, rtol=1e-5)


def _serve(den, log_path):
    server = tds.DenoiseHTTPServer(("127.0.0.1", 0), tds.make_handler(den, log_path))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _ask(port, text, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/ask",
        data=json.dumps({"noisyasr": text}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_denoiser_service_roundtrip(cfg_path, tmp_path):
    den = tds.Denoiser(cfg_path, None, max_len=64, top_p=0.94, max_ctx=32,
                       device="cpu")
    server, port = _serve(den, str(tmp_path / "log.jsonl"))
    try:
        out = _ask(port, "so today were gonna make pasta")
        assert isinstance(out["gen"], str) and isinstance(out["ppl"], float)
        assert "cleanasr" in (tmp_path / "log.jsonl").read_text()
        assert server.request_queue_size == 128
    finally:
        server.shutdown()
        server.server_close()


def test_denoiser_dynamic_batching_and_stats(cfg_path, tmp_path):
    """Concurrent requests coalesce: all succeed, fewer sampler calls than
    requests, and /stats says so."""
    den = tds.Denoiser(cfg_path, None, max_len=64, top_p=0.94, max_ctx=32,
                       batch_window_ms=3000.0, max_batch=4, device="cpu")
    server, port = _serve(den, str(tmp_path / "log.jsonl"))
    results, errors = [], []

    def ask(text):
        try:
            results.append(_ask(port, text, timeout=600))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["sampler_calls"] == 0 and stats["top_p"] == 0.94
        threads = [threading.Thread(target=ask, args=(f"recipe number {i} " + "pasta " * i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors, errors
        assert len(results) == 4 and all("gen" in r and "ppl" in r for r in results)
        assert den.engine.requests == 4 and den.engine.calls < 4
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["batched_requests"] == 4 and stats["mean_batch"] > 1
        assert len((tmp_path / "log.jsonl").read_text().strip().splitlines()) == 4
    finally:
        server.shutdown()
        server.server_close()


def test_denoiser_loads_pp_checkpoint(cfg_path, tmp_path):
    """An unfused checkpoint written by a pipeline-parallel run (stacked
    ``stages`` leaves) loads into the fused serving model, whose logits
    equal the JAX model's on the unstacked weights."""
    model = jg.GroverLM(jg.GroverConfig(**TINY))
    ids = np.random.default_rng(1).integers(1, 50000, (2, 8)).astype(np.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    pp = jg.stack_grover_params(variables, 2)
    den = tds.Denoiser(cfg_path, _save_npz(tmp_path / "pp.npz", pp["params"]),
                       max_len=64, max_ctx=32, batch_window_ms=0.0, device="cpu")
    assert den.cfg.fused_qkv and den.cfg.stacked_kv
    want, _ = jax.jit(lambda v, i: model.apply(v, i))(variables, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = den.model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    text, ppl = den.denoise("check the weather")
    assert isinstance(text, str) and (np.isfinite(ppl) or ppl == float("inf"))


def test_denoiser_refuses_without_card_or_with_tp(cfg_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.Denoiser(cfg_path, None, max_len=64)
    with pytest.raises(ValueError, match="tensor-parallel"):
        tds.Denoiser(cfg_path, None, max_len=64, tp=2, device="cpu")
    with pytest.raises(SystemExit):
        tds.main(["--config", cfg_path, "--tp", "2", "--device", "cpu"])


def test_extract_generated_target_matches_jax():
    tok = tds.get_grover_tokenizer()
    ids = tok.encode("hello there general")
    toks = np.array([5, tok.begin_article, *ids, tok.end_article, 17], np.int64)
    assert tds.extract_generated_target(toks, tok, tok.begin_article, tok.end_article) \
        == jds.extract_generated_target(toks, tok, tok.begin_article, tok.end_article) \
        == "hello there general"
