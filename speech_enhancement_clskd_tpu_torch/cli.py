"""Command-line entry points of the port.

    python -m speech_enhancement_clskd_tpu_torch distill --strategy clskd [k=v ...]

The same parser as ``speech_enhancement_clskd_tpu/cli.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path, as the
tests do).  Every config field is overridable as a dotted key=value
(``config.load_config``), e.g. ``optim.lr=1e-3 data.batch_size=16
data.synthetic=true``; only ``--config`` (a YAML file) needs ``yaml``.

``distill`` trains with ``Trainer.fit``, keeps the top-k checkpoints on
``cfg.monitor`` in ``--out``, restores the best one and writes
``<out>/the_best_model.npz``.  ``evaluate`` runs ``eval.evaluate_bundle`` on
an ``.npz`` bundle or an asteroid ``.pth`` over the configured test set
(``data.synthetic=true`` for the synthetic one).  ``import-torch`` converts
an asteroid ``.pth`` into an ``.npz`` bundle.  ``pretrain`` and ``bench``
are in the parser and raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

# the subcommands not ported yet, and the ROADMAP queue 1 item of each
_UNPORTED = {
    "pretrain": "item 7 (pretraining)",
    "bench": "item 9 (the port benchmark)",
}


def _parse(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog="speech_enhancement_clskd_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser("distill", help="knowledge-distillation training")
    d.add_argument("--config", default=None, help="YAML config file (needs yaml)")
    d.add_argument("--strategy", default=None,
                   choices=["clskd", "reviewkd", "spkd", "mse", "stft"])
    d.add_argument("--teacher-bundle", default=None,
                   help="pretrained teacher bundle (.npz)")
    d.add_argument("--out", default="checkpoints",
                   help="checkpoint/bundle output dir")
    d.add_argument("--resume", action="store_true",
                   help="resume from the best checkpoint in --out")
    d.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    d.add_argument("overrides", nargs="*", help="dotted key=value overrides")

    t = sub.add_parser("pretrain", help="standalone DCCRN training (teacher)")
    t.add_argument("--config", default=None)
    t.add_argument("--model", default="teacher", choices=["teacher", "student"])
    t.add_argument("--out", default="checkpoints_pretrain")
    t.add_argument("overrides", nargs="*")

    e = sub.add_parser("evaluate", help="offline metric evaluation")
    e.add_argument("--bundle", required=True,
                   help=".npz bundle or asteroid .pth (auto-detected)")
    e.add_argument("--config", default=None)
    e.add_argument("--results", default="results/All_metric.json")
    e.add_argument("--examples", default=None, help="example wav dir")
    e.add_argument("--no-pesq", action="store_true")
    e.add_argument("--per-utt", default=None, dest="per_utt",
                   help="per-utterance metric rows JSONL (default: derived "
                        "from --results)")
    e.add_argument("--reference-bn", action="store_true",
                   help="BatchNorm with per-utterance batch statistics, "
                        "matching the reference eval.py (no model.eval())")
    e.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    e.add_argument("overrides", nargs="*")

    i = sub.add_parser(
        "import-torch",
        help="convert an asteroid publishable .pth into a native .npz bundle",
    )
    i.add_argument("--pth", required=True)
    i.add_argument("--out", required=True, help="output bundle path (.npz)")

    b = sub.add_parser("bench", help="train-step throughput bench")
    b.add_argument("overrides", nargs="*")

    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(argv)
    if args.command in _UNPORTED:
        raise NotImplementedError(
            f"not ported yet: the {args.command!r} subcommand is ROADMAP queue 1 "
            f"{_UNPORTED[args.command]}")
    if args.command == "import-torch":
        return _import_torch(args)
    from .config import load_config

    overrides = list(args.overrides)
    if getattr(args, "strategy", None):
        overrides.append(f"distill.strategy={args.strategy}")
    cfg = load_config(args.config, overrides)
    if args.command == "evaluate":
        return _evaluate(cfg, args)
    return _distill(cfg, args)


def _distill(cfg, args) -> int:
    from .train.trainer import Trainer
    from .utils.observability import MetricWriter
    from .utils.serialization import CheckpointManager, load_bundle

    trainer = Trainer(cfg, device=args.device)
    teacher_vars = None
    if args.teacher_bundle:
        tcfg, teacher_vars, _ = load_bundle(args.teacher_bundle)
        if tcfg.kernel_num != cfg.teacher.kernel_num:
            raise SystemExit(
                f"teacher bundle geometry {tcfg.kernel_num} != config "
                f"{cfg.teacher.kernel_num}")

    mgr = CheckpointManager(args.out, monitor=cfg.monitor, keep_top_k=cfg.keep_top_k)
    writer = MetricWriter(os.path.join(args.out, "metrics.jsonl"))
    trainer.init_state(teacher_variables=teacher_vars)
    if args.resume and mgr.best_step() is not None:
        mgr.restore(trainer)
        print(f"resumed from step {trainer.step}")
    history = trainer.fit(checkpoint_manager=mgr, metric_writer=writer)
    writer.close()
    bundle_path = bundle_best(trainer, mgr, history, args.out)
    print(json.dumps({"final_metrics": history, "bundle": bundle_path}))
    return 0


def bundle_best(trainer, mgr, history, out: str, log_fn=print) -> str:
    """Write ``<out>/the_best_model.npz`` from the BEST checkpoint
    by the monitored metric, restoring it into ``trainer`` first unless the
    trainer is at that step — the reference reloads the top checkpoint
    before serializing (distill.py:280-294), not the final epoch's weights.
    Returns the bundle's path."""
    from .utils.serialization import save_bundle, student_from_state

    cfg = trainer.cfg
    if mgr.best_step() is not None and trainer.step != mgr.best_step():
        mgr.restore(trainer)
        log_fn(f"bundling best checkpoint (step {mgr.best_step()}, "
               f"{cfg.monitor}={mgr.best_score():.4f})")
    bundle_path = os.path.join(out, "the_best_model")
    v = student_from_state(trainer, cfg.student)
    save_bundle(bundle_path, v["params"], v["batch_stats"], cfg.student,
                infos={"history": history, "strategy": cfg.distill.strategy})
    return bundle_path + ".npz"


def _evaluate(cfg, args) -> int:
    from .data.librimix import LibriMixDataset
    from .data.synthetic import SyntheticEnhancementDataset
    from .eval import evaluate_bundle

    d = cfg.data
    if d.synthetic:
        ds = SyntheticEnhancementDataset(
            size=d.synthetic_size, segment=d.segment,
            sample_rate=d.sample_rate, seed=cfg.seed + 20_000,
            profile=d.synthetic_profile)
    else:
        ds = LibriMixDataset(d.test_dir, d.task, d.sample_rate, d.n_src, segment=None)
    per_utt = args.per_utt
    if per_utt is None and args.results:
        per_utt = os.path.splitext(args.results)[0] + "_per_utt.jsonl"
    res = evaluate_bundle(
        args.bundle, ds,
        sample_rate=d.sample_rate,
        ex_save_dir=args.examples,
        results_path=args.results,
        compute_pesq=not args.no_pesq,
        bn_batch_stats=True if args.reference_bn else None,
        per_utt_path=per_utt,
        device=args.device,
    )
    print(json.dumps(res, indent=2))
    return 0


def _import_torch(args) -> int:
    """Asteroid publishable .pth -> native .npz bundle."""
    from .models.dccrnet import read_reference_bundle
    from .utils.serialization import save_bundle

    cfg, variables, ck = read_reference_bundle(args.pth)
    save_bundle(
        args.out,
        variables["params"],
        variables["batch_stats"],
        cfg,
        infos={
            "imported_from": args.pth,
            "source_model_name": ck.get("model_name"),
            "source_infos": ck.get("infos", {}),
        },
    )
    print(json.dumps({"bundle": args.out if args.out.endswith(".npz")
                      else args.out + ".npz",
                      "architecture": cfg.name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
