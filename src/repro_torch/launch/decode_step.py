"""Time one decode step of a serving wave at full width and depth.

Draws the architecture's params from ``--seed`` on the device, prefills
``--batch`` prompts of ``--prompt`` tokens, then runs 2 + ``STEPS``
greedy decode steps one after another, each synchronised before the
next (the first two are not timed). Prints the median step time, the
median host time to issue a step (the call's return, before the device
is done) and, on the card, its name and power limit as ``nvidia-smi``
gives them:

    PYTHONPATH=src python -m repro_torch.launch.decode_step \\
        --arch granite-8b --batch 4 --prompt 4096

To compare two versions of the package on one card, run this module
from each tree in one session (``PYTHONPATH=<tree>/src``), alternating.
``--reduced`` runs the architecture's ``reduced()`` config (a quick
check on the host: ``main([...], device="cpu")``). The vlm and audio
families get a stub frontend drawn after the prompt (``--prompt`` counts
the text alone: llava-next-mistral-7b's 2880 patches come before it).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model

STEPS = 20


def _card(dev) -> str:
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    model = get_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (args.batch, args.prompt)),
                           dtype=torch.int32).to(dev)
    batch = {"tokens": toks}
    if cfg.family in ("vlm", "audio"):
        # the stub frontend, drawn after the prompt as launch/serve.py does
        batch["frontend"] = torch.as_tensor(rng.normal(
            scale=0.02, size=(args.batch, cfg.frontend_len,
                              cfg.frontend_dim or cfg.d_model)),
            dtype=torch.float32).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    issue, step = [], []
    with torch.no_grad():
        logits, state = model.prefill_fn(params, batch)
        for i in range(STEPS + 2):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            sync()
            t0 = time.perf_counter()
            logits, state = model.decode_fn(params, state, {"token": tok})
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            if i >= 2:
                issue.append((t1 - t0) * 1e3)
                step.append((t2 - t0) * 1e3)
    ok = bool(torch.isfinite(logits.float()).all())
    name = cfg.name + (" (reduced)" if args.reduced else "")
    print(f"{name} decode step, batch {args.batch} after {args.prompt} "
          f"tokens: "
          f"{statistics.median(step):.2f} ms synchronised (median of "
          f"{len(step)}), host issue {statistics.median(issue):.2f} ms; "
          f"finite logits {ok} [{_card(dev)}]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
