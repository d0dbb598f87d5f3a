"""Serving launcher: batched prefill + greedy decode loop.

The port of ``src/repro/launch/serve.py``, with the same flags and
``--device`` (``cuda``, the default, or ``cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --tokens 16 --device cpu

prefills a batch of prompts and decodes N tokens per sequence, reporting
per-token latency. With ``--sync-spool DIR`` (the spool of
``launch/train.py --publish-deltas DIR``) a ``DeltaSubscriber`` folds the
trainer's parameter deltas into the live parameters between decode steps
(a window of missed epochs in one ragged SpKAdd through the engine, or a
reload of the shadow checkpoint past ``--max-staleness``) and the replica
hot-swaps them before the next token.

The parameters are the model's seed-0 init (the trainer's initial
parameters), the prompts uniform tokens from a ``torch.Generator`` seeded
with 1 (the VLM's prompts zero patch embeddings, and the encoder-decoder
encodes zero frame embeddings, as the reference's). Every family serves:
``--arch whisper-medium`` and ``--arch mamba2-370m`` too.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.sparse import resolve_device
from repro_torch.models import build_model
from repro_torch.models.layers import use_full_precision
from repro_torch.runtime import DeltaSubscriber, DirTransport
from repro_torch.train import make_decode_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--sync-spool", default=None, metavar="DIR",
                    help="subscribe to a trainer's delta spool "
                         "(train.py --publish-deltas DIR): fold parameter "
                         "deltas into live params between decode steps")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="hard staleness bound (epochs) before the replica "
                         "degrades to a shadow-checkpoint reload")
    ap.add_argument("--sync-every-tokens", type=int, default=1,
                    help="run one sync round every N decoded tokens")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model serves (default: the CUDA card)")
    return ap.parse_args(argv)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    """Serve as the flags say; print the reference's lines. Returns the
    run's numbers, the final parameters (``params``), the tokens decoded
    (``tokens``, (B, N)) and the subscriber (``None`` without a spool)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(args.device)
    use_full_precision()
    params = model.init(0, device=dev)
    B, S = args.batch, args.prompt_len
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         dtype=torch.int32).to(dev)

    # the stub frontends' inputs are zeros: the VLM prefills on patch
    # embeddings, the encoder-decoder on frame embeddings beside its tokens
    if cfg.family == "vlm":
        prompt = {"embeds": torch.zeros((B, S, cfg.d_model),
                                        dtype=cfg.cdtype, device=dev)}
    else:
        prompt = {"tokens": toks}
    if cfg.family == "encdec":
        prompt["embeds"] = torch.zeros((B, cfg.n_frames, cfg.d_model),
                                       dtype=cfg.cdtype, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, **prompt,
                                   max_len=S + args.tokens, attn_chunk=32)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"prefill {B}x{S}: {prefill_ms:.1f} ms", flush=True)

    subscriber = None
    if args.sync_spool:
        subscriber = DeltaSubscriber(
            params, DirTransport(args.sync_spool),
            max_staleness=args.max_staleness,
            ckpt_dir=os.path.join(args.sync_spool, "ckpt"), device=dev)

    decode = make_decode_step(model, attn_chunk=128)
    tok = torch.argmax(logits, -1)
    outs = [tok]
    plain_lat, swap_lat = [], []
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        t_tok = time.perf_counter()
        swapped = False
        if subscriber is not None and i % args.sync_every_tokens == 0:
            report = subscriber.sync()
            if report.window or report.degraded:
                params = subscriber.params  # hot-swap between tokens
                swapped = True
        logits, caches = decode(params, caches, tok)
        tok = torch.argmax(logits, -1)
        outs.append(tok)
        if subscriber is not None:
            # per-token blocking so hot-swap jitter is measurable
            _sync(dev)
            lat = (time.perf_counter() - t_tok) * 1e3
            (swap_lat if swapped else plain_lat).append(lat)
            obs.histogram("delta_sync.decode_latency_ms").observe(lat)
    _sync(dev)
    dt = time.perf_counter() - t0
    per_tok = dt / max(1, args.tokens - 1) * 1e3
    print(f"decoded {args.tokens} tokens/seq: {per_tok:.1f} ms/token "
          f"({B / (per_tok / 1e3):.1f} tok/s aggregate)")
    tokens = torch.stack(outs, dim=1)
    print("sample token ids:", [int(t) for t in tokens[0, :10]])
    med = swp = 0.0
    if subscriber is not None:
        med = sorted(plain_lat)[len(plain_lat) // 2] if plain_lat else 0.0
        swp = max(swap_lat) if swap_lat else 0.0
        print(f"delta-sync: applied_epoch={subscriber.applied_epoch} "
              f"degradations={subscriber.degradations} "
              f"retries={subscriber.total_retries}; decode latency "
              f"median {med:.1f} ms, worst hot-swap token {swp:.1f} ms",
              flush=True)
    return {"prefill_ms": prefill_ms, "ms_per_token": per_tok,
            "median_token_ms": med, "worst_swap_token_ms": swp,
            "params": params, "tokens": tokens, "subscriber": subscriber}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
