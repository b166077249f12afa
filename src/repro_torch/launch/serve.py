"""Batched serving driver on a reduced config (the port of
``repro.launch.serve``).

Prefills a batch of prompts and decodes tokens auto-regressively through
the KV cache / recurrent state with the model's ``prefill_fn`` and
``decode_fn``. The flags and the default
architecture (stablelm-1.6b) are the reference's. It runs on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch stablelm-1.6b --batch 4 --prompt-len 32 --new-tokens 16

and on the host when a caller asks for it, as every port entry point:

    PYTHONPATH=src python -c "from repro_torch.launch.serve import main; \\
        main(['--arch', 'recurrentgemma-2b'], device='cpu')"
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch).reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), dev)

    b, s = args.batch, args.prompt_len
    rng_np = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(rng_np.integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32).to(dev)
    batch = {"tokens": prompt}
    if cfg.family in ("vlm", "audio"):
        batch["frontend"] = torch.as_tensor(rng_np.normal(
            scale=0.02, size=(b, cfg.frontend_len,
                              cfg.frontend_dim or cfg.d_model)),
            dtype=torch.float32).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, state = model.prefill_fn(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out_tokens = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        logits, state = model.decode_fn(params, state, {"token": tok})
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out_tokens.append(tok.cpu().numpy())
    sync()
    t_decode = time.perf_counter() - t0

    gen = np.concatenate(out_tokens, axis=1)
    print(f"arch={cfg.name} (reduced) batch={b} prompt={s} "
          f"new={args.new_tokens} device={dev}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({b * s / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode : {t_decode * 1e3:.1f} ms "
          f"({b * (args.new_tokens - 1) / max(t_decode, 1e-9):.0f} tok/s)")
    print("sample tokens:", gen[0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
