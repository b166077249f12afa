"""End-to-end federated training driver (the port of
``repro.launch.train``).

Runs the paper's system for real: N heterogeneous clients train a model
on non-IID synthetic data; every round a placement strategy (PSO /
random / uniform / greedy / ga) proposes the aggregation tree; the
orchestrator measures the black-box TPD and feeds it back. This is the
single-host emulation of the docker/MQTT deployment (paper Sec. IV-C).
The flags are the reference's; language-model architectures run their
``reduced()`` variant, as in the reference. It runs on the card:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch paper-mlp-1m8 --strategy pso --rounds 50 --clients 15

and on the host when a caller asks for it, as every port entry point:

    PYTHONPATH=src python -c "from repro_torch.launch.train import main; \\
        main(['--arch', 'stablelm-1.6b', '--rounds', '3'], device='cpu')"
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.cost_model import CostModel
from repro_torch.core.hierarchy import ClientPool
from repro_torch.core.registry import create_strategy, list_strategies
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.distributed import choose_fl_hierarchy
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="paper-mlp-1m8")
    # only strategies constructible from (hierarchy, clients, cost_model)
    # alone: ones with required config fields (static's placement) have
    # no CLI surface here
    cli_ok = [i.name for i in list_strategies()
              if all(f.default is not dataclasses.MISSING
                     or f.default_factory is not dataclasses.MISSING
                     for f in dataclasses.fields(i.config_cls))]
    ap.add_argument("--strategy", default="pso", choices=sorted(cli_ok))
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=15)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config of --arch")
    ap.add_argument("--out", default=None, help="write round records JSON")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if cfg.family != "mlp":
        # language-model architectures run their reduced variant
        cfg = cfg.reduced()
    model = get_model(cfg)

    hierarchy = choose_fl_hierarchy(args.clients)
    clients = ClientPool.random(hierarchy.total_clients, seed=args.seed)
    data = make_federated_dataset(
        cfg, n_clients=hierarchy.total_clients, seed=args.seed)

    strategy = create_strategy(
        args.strategy, hierarchy, seed=args.seed, clients=clients,
        cost_model=CostModel(hierarchy, clients, device=dev))
    orch = FederatedOrchestrator(
        model, hierarchy, clients, data,
        local_steps=args.local_steps, batch_size=args.batch_size,
        seed=args.seed, device=dev)
    result = orch.run(strategy, rounds=args.rounds, verbose=args.verbose)
    summary = result.summary()
    print(json.dumps(summary, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps({
            "summary": summary,
            "rounds": [vars(r) for r in result.rounds],
        }, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
