"""The offline lane's CLI: ``python -m llm_weighted_consensus_tpu_torch.train
fit|rescore [--device cuda|cpu]``.

The port's copy of ``llm_weighted_consensus_tpu/train/__main__.py``, with
the reference's flags plus ``--device`` (the card unless ``cpu``):

``fit``
    Stream the ledger shards under ``--ledger-dir`` (default: the
    server's ``LEDGER_DIR``) through the learner (``train/fit.py``) and
    print the versioned weights report.  ``--labels`` is a JSON file of
    record id -> candidate index.  ``--out`` writes the table in the
    ``lwc.weights.v1`` format ``WEIGHTS_PATH`` loads at startup; ``--put
    URL`` hot-swaps it into a running server with ``PUT /v1/weights``
    (``--put-mode active|shadow``).

``rescore``
    Build the environment's embedder with the server's own
    ``build_embedder``, assemble candidate groups from the
    ``ARCHIVE_PATH`` snapshot (or ``--synthetic N`` deterministic groups)
    and drive them through the batcher's offline lane.  Prints the
    groups and items pushed, the errors and the offline occupancy.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

from ..utils import jsonutil


def _cmd_fit(args) -> int:
    from .fit import fit_from_ledger

    if not args.ledger_dir:
        # the CLI's default is the server's own LEDGER_DIR, so fit trains
        # on what serve wrote
        from ..serve.config import ServeConfig

        args.ledger_dir = ServeConfig.from_env().ledger_dir
    if not args.ledger_dir:
        print(
            "fit: no ledger directory (--ledger-dir or LEDGER_DIR)",
            file=sys.stderr,
        )
        return 2
    labels = None
    if args.labels:
        with open(args.labels, encoding="utf-8") as f:
            labels = {
                str(k): int(v) for k, v in jsonutil.loads(f.read()).items()
            }
    report = fit_from_ledger(
        args.ledger_dir,
        labels=labels,
        steps=args.steps,
        lr=args.lr,
        holdout_every=args.holdout_every,
        device=args.device,
    )
    if report is None:
        print("fit: no trainable records in the ledger", file=sys.stderr)
        return 1
    if args.out:
        from ..utils.io import atomic_write
        from ..weights.live import table_document

        payload = table_document({
            "version": report["version"],
            "weights": {k: str(v) for k, v in report["weights"].items()},
        })
        atomic_write(args.out, lambda f: f.write(payload))
    if args.put:
        import urllib.request

        body = jsonutil.dumps(
            {
                "version": report["version"],
                "weights": report["weights"],
                "mode": args.put_mode,
            }
        ).encode("utf-8")
        req = urllib.request.Request(
            args.put.rstrip("/") + "/v1/weights",
            data=body,
            method="PUT",
            headers={"content-type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            report["put"] = jsonutil.loads(resp.read().decode("utf-8"))
    print(jsonutil.dumps(report))
    return 0


def _cmd_rescore(args) -> int:
    from ..serve.__main__ import build_embedder
    from ..serve.batcher import DeviceBatcher
    from ..serve.config import ServeConfig, process_env
    from .feed import OfflineFeed, archive_groups, synthetic_groups

    env = process_env()
    config = ServeConfig.from_env(env)
    if not env.get("EMBEDDER_MODEL"):
        print("rescore: no embedder configured (EMBEDDER_MODEL)",
              file=sys.stderr)
        return 2
    if args.synthetic:
        groups = synthetic_groups(args.synthetic, args.n, seed=args.seed)
    else:
        from ..archive import InMemoryArchive

        if not config.archive_path or not os.path.exists(
            config.archive_path
        ):
            print(
                "rescore: no archive snapshot (ARCHIVE_PATH); use "
                "--synthetic N for a synthetic feed",
                file=sys.stderr,
            )
            return 2
        store = InMemoryArchive.load(config.archive_path)
        groups = list(archive_groups(store))
    embedder = build_embedder(env, device=args.device)
    batcher = DeviceBatcher(
        embedder,
        None,
        window_ms=config.batch_window_ms,
        max_batch=config.batch_max,
        pipeline_depth=config.batch_pipeline,
        max_rows=config.batch_max_rows,
        host_tokenizer_workers=config.host_tokenizer_workers,
        **config.packing,
    )
    try:
        feed = OfflineFeed(batcher, inflight=args.inflight)
        t0 = time.perf_counter()
        _results, occupancy = asyncio.run(feed.drive(groups))
        wall = time.perf_counter() - t0
        stats = {
            "groups": feed.groups,
            "items": feed.items,
            "errors": feed.errors,
            "wall_sec": round(wall, 3),
            "offline_occupancy": occupancy,
            "lanes": batcher.utilization()["lanes"],
        }
    finally:
        batcher.close()
    print(jsonutil.dumps(stats))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llm_weighted_consensus_tpu_torch.train"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    fit = sub.add_parser("fit", help="fit per-judge weights from the ledger")
    fit.add_argument(
        "--ledger-dir", default=None, help="default: the server's LEDGER_DIR"
    )
    fit.add_argument(
        "--labels",
        default=None,
        help="JSON file mapping record id -> candidate label (supervised); "
        "without it, records score self-consistently against their winner",
    )
    fit.add_argument("--steps", type=int, default=300)
    fit.add_argument("--lr", type=float, default=0.1)
    fit.add_argument("--holdout-every", type=int, default=4)
    fit.add_argument(
        "--out", default=None, help="write the lwc.weights.v1 table here"
    )
    fit.add_argument(
        "--put",
        default=None,
        help="base URL of a running server to hot-swap via PUT /v1/weights",
    )
    fit.add_argument("--put-mode", choices=("active", "shadow"),
                     default="active")
    fit.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    fit.set_defaults(run=_cmd_fit)

    rescore = sub.add_parser(
        "rescore", help="drive archive/synthetic groups through the offline lane"
    )
    rescore.add_argument(
        "--synthetic",
        type=int,
        default=0,
        help="drive N deterministic synthetic groups instead of the archive",
    )
    rescore.add_argument("--n", type=int, default=8,
                         help="candidates per group")
    rescore.add_argument("--seed", type=int, default=0)
    rescore.add_argument("--inflight", type=int, default=4)
    rescore.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    rescore.set_defaults(run=_cmd_rescore)

    args = parser.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
