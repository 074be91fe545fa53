"""Grover ASR-denoising service (counterpart of
merlot_tpu/tools/denoise_server.py): a stdlib ThreadingHTTPServer around the
port's seq2seq sampler.

  POST /api/ask  {"noisyasr": "...", "target": "cleanasr"|"noisyasr"}
    -> {"gen": cleaned_text, "ppl": context_perplexity}
  GET /stats     -> the batching engine's counters

Context format: ``<begintitle> noisy <endoftitle> <beginarticle>``, then
generate until ``<endofarticle>`` (nucleus p=0.94, context cut to its last
1280 tokens). Concurrent requests coalesce into one batched sampler run;
every request is logged to a JSONL file.

    python -m merlot_tpu_torch.tools.denoise_server \\
        --config configs/grover_medium.json --bf16 [--ckpt params.npz]

It runs on CUDA unless ``--device cpu`` is given. ``--ckpt`` takes a .npz
of numpy leaves keyed by '/'-joined flax path (with or without a leading
``params/``); a pipeline-parallel checkpoint's ``stages`` leaves are
unstacked. Without it the weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import signal
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.core.tokenizer import get_grover_tokenizer
from merlot_tpu_torch.models.grover import (GroverConfig, GroverLM,
                                            cast_params_for_serving,
                                            fuse_qkv_for_serving,
                                            make_seq2seq_sampler,
                                            unstack_grover_params)
from merlot_tpu_torch.nn.layers import init_params


def _ceil_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the denoiser was asked for CUDA but no CUDA device "
                           "is present (pass device='cpu' to run on the CPU)")
    return dev


def load_npz_params(path: str, num_layers: int) -> Dict[str, np.ndarray]:
    """Flax-path numpy leaves from a .npz, with any leading 'params/' cut
    and pipeline-parallel ``stages`` leaves unstacked."""
    with np.load(path) as z:
        flat = {k[len("params/"):] if k.startswith("params/") else k: z[k]
                for k in z.files}
    if any(k.startswith("stages/") for k in flat):
        flat = unstack_grover_params(flat, num_layers)
    return flat


def extract_generated_target(output_tokens, tokenizer, begin_token: int,
                             end_token: int) -> str:
    """Text between the first begin_token and the first end_token after it."""
    toks = [int(t) for t in output_tokens]
    start = toks.index(begin_token) + 1 if begin_token in toks else 0
    try:
        end = toks.index(end_token, start)
    except ValueError:
        end = len(toks)
    return tokenizer.decode([t for t in toks[start:end]
                             if t in tokenizer.decoder]).strip()


class Denoiser:
    """Loads the LM once; ``denoise()`` is the whole inference path."""

    def __init__(self, config_path: str, ckpt_path: Optional[str] = None,
                 max_len: int = 1537, top_p: float = 0.94,
                 max_ctx: int = 1280, bf16: bool = False,
                 k_prefilter: int = 128, tp: int = 1,
                 fuse_qkv: bool = True,
                 batch_window_ms: float = 15.0, max_batch: int = 8,
                 device="cuda"):
        if tp > 1:
            raise ValueError("tensor-parallel serving (tp > 1) is not ported: "
                             "the port serves on one card (ROADMAP M7)")
        self.device = _device(device)
        self.tok = get_grover_tokenizer()
        self.cfg = GroverConfig.from_json_file(config_path)
        if bf16:  # bf16 matrices, activations and KV cache
            self.cfg = dataclasses.replace(self.cfg, use_bfloat16=True)
        # one [H, 3H] qkv product per layer, and one [B, L, 2H] cache buffer
        # per layer written as the k‖v column slice of its output
        self.fuse_qkv = fuse_qkv
        if fuse_qkv:
            self.cfg = dataclasses.replace(self.cfg, fused_qkv=True, stacked_kv=True)
        self.max_len = max_len
        self.top_p = top_p
        self.max_ctx = max_ctx
        self.bf16 = bf16
        self.k_prefilter = k_prefilter
        self.model = GroverLM(self.cfg, device=self.device).eval()
        if ckpt_path:
            flat = load_npz_params(ckpt_path, self.cfg.num_hidden_layers)
            if fuse_qkv:
                flat = fuse_qkv_for_serving(flat)
            load_flax_params(self.model, flat)
        else:  # random weights (smoke and serving-harness runs)
            init_params(self.model, torch.Generator(device=self.device).manual_seed(0))
        if bf16:
            cast_params_for_serving(self.model)
        self._gen = torch.Generator(device=self.device).manual_seed(int(time.time()))
        # one sampler run at a time: the card runs them in turn anyway, and
        # the generator is not thread-safe
        self._lock = threading.Lock()
        # dynamic request batching: concurrent /api/ask calls coalesce into
        # one batched sampler run (0 disables)
        self.engine = (BatchingEngine(self, max_batch=max_batch,
                                      window_ms=batch_window_ms)
                       if batch_window_ms > 0 and max_batch > 1 else None)

    def run_batch(self, ctxs: Sequence[Sequence[int]], eos: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One batched sampler call over several contexts.

        ``prefix_len`` is the min context length over rows (the reference's
        rule): the shared prefill never claims tokens a shorter row still
        needs force-fed. Under the batching engine it is bucketed down to
        pow2 and 1.5*pow2 rungs (the surplus is force-fed by the loop), as
        the JAX package does to bound its compiles. Context width and batch
        round up to powers of two, padding with all-pad rows that stop at
        once. Returns per-row (tokens [max_len], probs [max_len])."""
        min_len = min(len(c) for c in ctxs)
        max_len0 = max(len(c) for c in ctxs)
        prefix_len = min(min_len, self.max_len - 16)
        if self.engine is not None:
            p2 = 1 << (max(prefix_len, 1).bit_length() - 1)
            prefix_len = max(p2 + (p2 >> 1) if p2 + (p2 >> 1) <= prefix_len
                             else p2, 1)
        width = max(_ceil_pow2(max_len0), prefix_len)
        b = _ceil_pow2(len(ctxs))
        padded = np.zeros((b, width), np.int64)
        for i, c in enumerate(ctxs):
            padded[i, :len(c)] = c

        sampler = make_seq2seq_sampler(
            self.model, max_len=self.max_len, prefix_len=prefix_len,
            p_for_topp=self.top_p, eos_token=eos, k_prefilter=self.k_prefilter)
        with self._lock:
            tokens, probs = sampler(padded, self._gen)
            tokens, probs = tokens.cpu().numpy(), probs.cpu().numpy()
        return [(tokens[i], probs[i]) for i in range(len(ctxs))]

    def denoise(self, noisyasr: str, target: str = "cleanasr"):
        tok = self.tok
        ctx = [tok.begin_title] + tok.encode(noisyasr)
        if target == "noisyasr":
            eos = tok.end_title
        else:
            ctx += [tok.end_title, tok.begin_article]
            eos = tok.end_article
        ctx = ctx[-self.max_ctx:]

        if self.engine is not None:
            tokens, probs = self.engine.submit(ctx, eos).result()
        else:
            ((tokens, probs),) = self.run_batch([ctx], eos)

        field = "title" if target == "noisyasr" else "article"
        begin = getattr(tok, f"begin_{field}")
        end = getattr(tok, f"end_{field}")
        text = extract_generated_target(tokens, tok, begin, end)
        ctx_p = probs[1:max(len(ctx) - 1, 1) + 1]
        ctx_p = ctx_p[ctx_p > 0]
        ppl = float(np.exp(-np.mean(np.log(ctx_p)))) if len(ctx_p) else float("inf")
        return text, ppl


class BatchingEngine:
    """Dynamic request batching. Handler threads submit (context, eos) and
    block on a Future; one worker drains the queue, coalescing same-eos
    requests that arrive within ``window_ms`` (or until ``max_batch``) into
    one ``run_batch`` call. A request with another eos seeds the next batch."""

    def __init__(self, denoiser: "Denoiser", max_batch: int = 8,
                 window_ms: float = 15.0):
        self.d = denoiser
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self.calls = 0            # batched sampler calls
        self.requests = 0
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, ctx: Sequence[int], eos: int) -> Future:
        fut: Future = Future()
        self.q.put((list(ctx), eos, fut))
        return fut

    def _worker(self):
        carry = None
        while True:
            batch = [carry if carry is not None else self.q.get()]
            carry = None
            eos = batch[0][1]
            deadline = time.time() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    item = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if item[1] != eos:
                    carry = item
                    break
                batch.append(item)
            try:
                results = self.d.run_batch([c for c, _, _ in batch], eos)
                for (_, _, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:  # propagate to every caller
                for _, _, fut in batch:
                    fut.set_exception(e)
            self.calls += 1
            self.requests += len(batch)


class DenoiseHTTPServer(ThreadingHTTPServer):
    """A listen backlog of 128 (``$DENOISE_BACKLOG``), so that bursts of
    clients queue instead of being reset; non-daemon handler threads with
    ``block_on_close``, so ``shutdown()`` + ``server_close()`` let every
    accepted request finish and log before the process exits."""

    request_queue_size = int(os.environ.get("DENOISE_BACKLOG", "128"))
    daemon_threads = False
    block_on_close = True


def make_handler(denoiser: Denoiser, log_path: str):
    class Handler(BaseHTTPRequestHandler):
        def _send_json(self, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/stats":
                self.send_error(404)
                return
            eng = denoiser.engine
            self._send_json({
                "batched_requests": eng.requests if eng else 0,
                "sampler_calls": eng.calls if eng else 0,
                "mean_batch": eng.requests / eng.calls if eng and eng.calls else 0.0,
                "top_p": denoiser.top_p,
                "max_len": denoiser.max_len,
            })

        def do_POST(self):
            if self.path != "/api/ask":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            instance = json.loads(self.rfile.read(length) or "{}")
            target = instance.get("target", "cleanasr")
            text, ppl = denoiser.denoise(instance.get("noisyasr", ""), target)
            record = {**instance, target: text, "ppl": ppl, "top_p": denoiser.top_p}
            with open(log_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            self._send_json({"instance": instance, "gen": text, "ppl": ppl})

        def log_message(self, fmt, *args):
            print(f"[denoise-server] {fmt % args}", flush=True)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True,
                    help="GroverConfig json (e.g. configs/grover_medium.json)")
    ap.add_argument("--ckpt", default=None,
                    help=".npz of flax-path numpy leaves (random weights if absent)")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--max_len", type=int, default=1537)
    ap.add_argument("--top_p", type=float, default=0.94)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16-stored weights, activations and KV cache")
    ap.add_argument("--k_prefilter", type=int, default=128,
                    help="top-p sort prefilter (0 = full-vocab sort); rows whose "
                         "nucleus exceeds it climb the top-k ladder")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: only 1 is ported")
    ap.add_argument("--no_fuse_qkv", action="store_true",
                    help="keep the three q/k/v projections and the flat cache")
    ap.add_argument("--batch_window", type=float, default=15.0,
                    help="dynamic-batching window in ms (0 disables)")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="max coalesced requests per sampler call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log", default="denoise_log.jsonl")
    args = ap.parse_args(argv)
    if args.tp > 1:
        ap.error("--tp > 1 is not ported: tensor-parallel serving is ROADMAP M7")

    denoiser = Denoiser(args.config, args.ckpt, max_len=args.max_len,
                        top_p=args.top_p, bf16=args.bf16,
                        k_prefilter=args.k_prefilter,
                        fuse_qkv=not args.no_fuse_qkv,
                        batch_window_ms=args.batch_window,
                        max_batch=args.max_batch, device=args.device)
    server = DenoiseHTTPServer(("0.0.0.0", args.port),
                               make_handler(denoiser, args.log))

    def _drain(signum, frame):
        # shutdown() must come from another thread (this one is inside
        # serve_forever); server_close() then joins the handler threads
        print(f"[denoise-server] signal {signum}: draining in-flight "
              "requests...", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(f"READY FOR GENERATION on :{args.port} "
          f"(backlog {server.request_queue_size})", flush=True)
    server.serve_forever()
    server.server_close()
    print("[denoise-server] drained, exiting", flush=True)


if __name__ == "__main__":
    main()
