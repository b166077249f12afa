"""Time training steps of a moe model with each of two backwards of the
moe combine, alternating which runs first: the combine's own
(``models/moe.py``'s ``_Combine``, a gather a slot) and autograd's
backward of the same gather, its plain version, which adds every dropped
choice into one zero row (a run of duplicate indices the card adds one
after another).

    PYTHONPATH=src python -m repro_torch.launch.moe_combine_ab \\
        --arch granite-moe-1b-a400m --tokens 2048 --pairs 6

Params are drawn from ``--seed`` on the device and AdamW (lr 3e-4) steps
them on one batch of 1 x ``--tokens``; a warm-up pair runs first. Prints
each form's step times (host clock, synchronised), their medians, how
many pairs the combine's own backward won, and, on the card, its name
and power limit as ``nvidia-smi`` gives them. ``--reduced`` runs the
architecture's ``reduced()`` config (a quick check on the host:
``main([...], device="cpu")``).
"""
from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.decode_step import _card
from repro_torch.models import get_model, moe
from repro_torch.models.api import flat_params, make_train_step
from repro_torch.optim import adamw


def plain_combine(ye: torch.Tensor, gi: torch.Tensor, choices: torch.Tensor,
                  t: int) -> torch.Tensor:
    """``moe.combine`` with autograd's backward of its gather."""
    e, c, d = ye.shape
    dev = ye.device
    slot = torch.full((e, t), e * c, dtype=torch.long, device=dev)
    slot.scatter_(1, gi, torch.arange(e * c, device=dev).view(e, c))
    rows = slot[choices, torch.arange(t, device=dev)[:, None]]
    table = torch.cat([ye.reshape(e * c, d), ye.new_zeros(1, d)])
    return table[rows].sum(dim=1)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    if cfg.moe is None:
        raise SystemExit(f"{args.arch} has no moe layers")
    model = get_model(cfg)
    opt = adamw(3e-4)
    step_fn = make_train_step(model, opt)
    params = flat_params(model.init(
        torch.Generator(dev).manual_seed(args.seed), dev))
    state = opt.init(params)
    rng = np.random.default_rng(args.seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, args.tokens + 1)),
                           dtype=torch.int32).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    own = moe.combine
    times = {"own": [], "plain": []}
    losses = []
    try:
        for i in range(args.pairs + 1):            # pair 0 warms both up
            for form in (("plain", "own") if i % 2 == 0
                         else ("own", "plain")):
                moe.combine = plain_combine if form == "plain" else own
                sync()
                t0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, batch)
                sync()
                if i:
                    times[form].append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
    finally:
        moe.combine = own
    a, b = times["own"], times["plain"]
    wins = sum(x < y for x, y in zip(a, b, strict=True))
    name = cfg.name + (" (reduced)" if args.reduced else "")
    ok = all(math.isfinite(v) for v in losses)
    print(f"{name} training steps of 1 x {args.tokens} tokens, "
          f"{args.pairs} alternating pairs: the combine's own backward "
          f"{statistics.median(a):.1f} ms median {[round(v, 1) for v in a]}, "
          f"autograd's of the gather {statistics.median(b):.1f} ms "
          f"{[round(v, 1) for v in b]}; own ahead in {wins} of "
          f"{args.pairs}; finite losses {ok} [{_card(dev)}]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
