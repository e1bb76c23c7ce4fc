"""The port's batched server: ``repro.launch.serve`` on one device.

``serve`` prefills a batch of prompts, building each layer's decode cache
for the prompt and every token to come (``cache_len = prompt length +
new_tokens``), then decodes one token a step against the cache, which each
step updates in place.  It runs under ``torch.inference_mode()``.  With
``mesh=`` the cache and the parameters are the mesh's shards'
(``models.parallel_serve``), the tokens the same on every shard.

Usage (a reduced olmo on the CPU; on the card drop ``--device``; ``--arch``
names any decoder of the registry, recurrentgemma-2b and mamba2-370m too,
whose SSD layers take prompts of at most 128 tokens or a multiple of 128;
whisper-large-v3 and internvl2-1b also read frames or patches and are
served through ``steps.build_prefill_step`` and ``build_decode_step``):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 2 --prompt-len 8 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch mamba2-370m --batch 2 --prompt-len 8 --new-tokens 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import RunConfig, get_arch
from ..models import Decoder, make_model
from .steps import build_decode_step, build_prefill_step, tokens_only


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, run: RunConfig, prompts: np.ndarray, new_tokens: int = 32,
          mesh=None, params=None, greedy: bool = True, *, device=None):
    """prompts: (B, S0) ints.  Returns ``(generated (B, new_tokens) int64,
    stats)``; ``stats`` holds ``prefill_s``, ``decode_s``, ``tokens_per_s``
    (B * new_tokens over ``decode_s``), ``batch``, ``prompt_len`` and
    ``new_tokens``.  The positional parameters are the reference's, in its
    order; ``device`` is the port's own, by keyword only.  ``device=None``
    means ``"cuda"``; ``params`` (a ``Decoder`` on that device) replaces
    the initialisation from ``run.seed``.  Decoding is greedy, as the reference's: its
    ``greedy`` argument takes no other value here, and ``greedy=False``
    raises ``ValueError``, as does an architecture whose batch needs
    ``frames`` or ``patches`` (whisper, internvl2): the prompts are
    tokens only, as the reference's ``serve`` builds them."""
    if not greedy:
        raise ValueError("serve decodes greedily only; the reference's "
                         "serve takes the argmax whatever greedy says")
    tokens_only(cfg, "serve", "build_prefill_step and build_decode_step")
    built_p = build_prefill_step(cfg, run, device, mesh=mesh)
    device = built_p["device"]
    if params is None:
        params = make_model(cfg)["init"](run, device=device)
    if mesh is None:
        built_d = build_decode_step(cfg, run, device)
    else:
        from ..models.parallel import ShardedParams
        server = built_p["server"]
        built_d = dict(built_p, fn=server.decode)
        if isinstance(params, Decoder):
            params = ShardedParams.from_module(server.layout, params)

    b, s0 = prompts.shape
    batch = {"tokens": torch.from_numpy(np.asarray(prompts)).to(
        device, torch.int64)}
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = built_p["fn"](params, batch, s0 + new_tokens)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out = []
        tok = torch.argmax(logits, -1)[:, None]
        t1 = time.perf_counter()
        for i in range(new_tokens):
            out.append(tok[:, 0])
            logits, cache = built_d["fn"](params, cache, tok, s0 + i)
            tok = torch.argmax(logits, -1)[:, None]
        _sync(device)
        t_decode = time.perf_counter() - t1
        generated = torch.stack(out, dim=1).cpu().numpy()

    stats = {"prefill_s": t_prefill,
             "decode_s": t_decode,
             "tokens_per_s": b * new_tokens / max(t_decode, 1e-9),
             "batch": b, "prompt_len": s0, "new_tokens": new_tokens}
    return generated, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run = RunConfig(seq_len=args.prompt_len, global_batch=args.batch,
                    dtype="float32")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    toks, stats = serve(cfg, run, prompts, args.new_tokens,
                        device=args.device)
    print(f"[serve] {cfg.name}: {stats}")
    print(f"[serve] sample continuation: {toks[0][:10]}")


if __name__ == "__main__":
    main()
