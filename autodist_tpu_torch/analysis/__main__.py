"""CLI: ``python -m autodist_tpu_torch.analysis <model> <strategy>``.

Port of the JAX package's ``analysis/__main__.py``: the same flags, output
text and exit codes.  Analyze a strategy against a model's variable catalog WITHOUT building a
mesh, tracing, or compiling anything — the whole point is a sub-second
verdict on a plan that would otherwise cost minutes of XLA compile to
reject.  Prints the diagnostics table and exits 1 when any ERROR rule
fires (0 otherwise; 2 on usage errors).

``model`` is a builtin demo catalog (``--list-models``) or a path to a
GraphItem catalog JSON (``GraphItem.serialize()`` output).  ``strategy``
is a builder class name from ``autodist_tpu_torch.strategy`` (built
against the virtual resource spec) or a path to a serialized Strategy
JSON.  A catalog's variables are ``meta`` tensors: nothing is allocated.
``--elastic-from`` runs the ``elastic/*`` rules, as ``analyze(elastic=...)``
does.
Without ``--mesh`` or a resource spec the mesh is the visible CUDA cards
(one on the CPU).

Examples::

    python -m autodist_tpu_torch.analysis linear_regression \
        PSLoadBalancing --mesh data=8
    python -m autodist_tpu_torch.analysis mlp AllReduce --mesh data=8 \
        --dump-ir dot
    python -m autodist_tpu_torch.analysis my_catalog.json strategy.json \
        --mesh data=8 --budget-gb 16 --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict


def _demo_models() -> Dict[str, dict]:
    """Builtin demo catalogs, mirroring the examples/ programs (shapes
    chosen so every shipped builder lowers cleanly on an 8-chip mesh)."""
    return {
        # examples/linear_regression.py: two scalars
        "linear_regression": {
            "params": {"w": ((), "float32"), "b": ((), "float32")},
        },
        # a small dense net (examples/image_classifier.py scale)
        "mlp": {
            "params": {
                "dense1": {"kernel": ((128, 64), "float32"),
                           "bias": ((64,), "float32")},
                "dense2": {"kernel": ((64, 8), "float32"),
                           "bias": ((8,), "float32")},
            },
        },
        # the same net in bf16 storage — the numerics/* rules' demo
        # (docs/numerics.md): low-precision gradients want the guard.
        "mlp_bf16": {
            "params": {
                "dense1": {"kernel": ((128, 64), "bfloat16"),
                           "bias": ((64,), "bfloat16")},
                "dense2": {"kernel": ((64, 8), "bfloat16"),
                           "bias": ((8,), "bfloat16")},
            },
        },
        # embedding LM slice (examples/lm1b): sparse vocab table
        "embedding_lm": {
            "params": {
                "emb": {"table": ((800, 64), "float32")},
                "proj": {"kernel": ((64, 64), "float32")},
            },
            "sparse_vars": ["emb/table"],
        },
        # examples/pipeline_1f1b.py: stage-stacked transformer blocks
        "pipeline": {
            "params": {
                "stages": {"w1": ((4, 32, 32), "float32"),
                           "w2": ((4, 32, 32), "float32")},
                "head": {"kernel": ((32, 64), "float32")},
            },
            "pipeline_vars": ["stages"],
        },
        # examples/moe_pipeline.py: expert-stacked FFN
        "moe": {
            "params": {
                "router": ((32, 4), "float32"),
                "wi": ((4, 32, 64), "float32"),
                "wo": ((4, 64, 32), "float32"),
            },
            "expert_vars": ["wi", "wo"],
        },
    }


def _meta(shape, dtype):
    import torch

    return torch.empty(tuple(shape), dtype=getattr(torch, str(dtype)),
                       device="meta")


def _build_graph_item(model_arg: str):
    from autodist_tpu_torch.graph_item import GraphItem

    def from_spec(spec: dict) -> GraphItem:
        def leafify(node):
            if isinstance(node, dict):
                return {k: leafify(v) for k, v in node.items()}
            shape, dtype = node
            return _meta(shape, dtype)

        return GraphItem(
            leafify(spec["params"]),
            sparse_vars=spec.get("sparse_vars", ()),
            untrainable_vars=spec.get("untrainable_vars", ()),
            pipeline_vars=spec.get("pipeline_vars", ()),
            expert_vars=spec.get("expert_vars", ()))

    demos = _demo_models()
    if model_arg in demos:
        return from_spec(demos[model_arg])
    if os.path.exists(model_arg):
        with open(model_arg, "r", encoding="utf-8") as f:
            d = json.load(f)
        if "variables" in d:  # GraphItem.serialize() catalog
            params = {v["name"]: _meta(v["shape"], v["dtype"])
                      for v in d["variables"]}
            return GraphItem(
                params,
                sparse_vars=[v["name"] for v in d["variables"]
                             if v.get("sparse")],
                untrainable_vars=[v["name"] for v in d["variables"]
                                  if not v.get("trainable", True)],
                pipeline_vars=[v["name"] for v in d["variables"]
                               if v.get("pipeline")],
                expert_vars=[v["name"] for v in d["variables"]
                             if v.get("expert")])
        return from_spec(d)  # {"params": {...}, "sparse_vars": [...]} form
    raise SystemExit(
        f"unknown model {model_arg!r}: not a builtin "
        f"({', '.join(sorted(demos))}) and not a file")


def _build_strategy(strategy_arg: str, graph_item, resource_spec):
    import autodist_tpu_torch.strategy as S

    if os.path.exists(strategy_arg):
        with open(strategy_arg, "r", encoding="utf-8") as f:
            return S.Strategy.from_dict(json.load(f))
    builder_cls = getattr(S, strategy_arg, None)
    if builder_cls is None or not (isinstance(builder_cls, type)
                                   and issubclass(builder_cls,
                                                  S.StrategyBuilder)):
        names = sorted(n for n in dir(S)
                       if isinstance(getattr(S, n), type)
                       and issubclass(getattr(S, n), S.StrategyBuilder)
                       and getattr(S, n) is not S.StrategyBuilder)
        raise SystemExit(
            f"unknown strategy {strategy_arg!r}: not a builder "
            f"({', '.join(names)}) and not a file")
    return builder_cls().build(graph_item, resource_spec)


def _parse_numerics(spec: str):
    """``--numerics`` grammar → a NumericsConfig (or None for 'off'):
    ``on`` / ``off`` / an on_nonfinite policy name / comma-separated
    ``field=value`` pairs (``loss_scale`` takes auto|none|<float>;
    ``clip_norm``/``spike_zscore`` floats; ``rollback_after`` int)."""
    from autodist_tpu_torch.numerics.policy import (ON_NONFINITE,
                                                    NumericsConfig)

    s = spec.strip()
    if s in ("off", "false", "0"):
        return None
    if s in ("on", "true", "1", "auto"):
        return NumericsConfig()
    if s in ON_NONFINITE:
        return NumericsConfig(on_nonfinite=s)
    fields: Dict[str, object] = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"bad --numerics entry {part!r}: use field=value, e.g. "
                "loss_scale=65536,clip_norm=1.0 (or on/off/skip/raise/"
                "rollback)")
        k, v = (x.strip() for x in part.split("=", 1))
        if k == "loss_scale":
            fields[k] = None if v in ("none", "off") else (
                v if v == "auto" else float(v))
        elif k in ("clip_norm", "spike_zscore"):
            fields[k] = None if v == "none" else float(v)
        elif k in ("rollback_after", "spike_window", "max_rollbacks"):
            fields[k] = int(v)
        elif k in ("guard", "reseed_on_rollback"):
            fields[k] = v in ("1", "true", "on", "yes")
        elif k == "on_nonfinite":
            fields[k] = v
        else:
            raise SystemExit(f"unknown --numerics field {k!r}")
    try:
        return NumericsConfig(**fields)
    except (TypeError, ValueError) as e:
        raise SystemExit(f"bad --numerics spec {spec!r}: {e}")


def _parse_mesh(mesh_arg: str) -> Dict[str, int]:
    axes: Dict[str, int] = {}
    for part in mesh_arg.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"bad --mesh entry {part!r}: use name=size, e.g. "
                "data=8,model=2")
        name, size = part.split("=", 1)
        axes[name.strip()] = int(size)
    if not axes:
        raise SystemExit("--mesh parsed to no axes")
    return axes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.analysis",
        description="Static strategy/sharding analyzer (shardlint): "
                    "pre-flight legality, sync-coverage, HBM, collective "
                    "and precision checks.  See docs/analysis.md.")
    parser.add_argument("model", nargs="?",
                        help="builtin demo model or catalog JSON path")
    parser.add_argument("strategy", nargs="?",
                        help="builder class name or Strategy JSON path")
    parser.add_argument("--mesh", default=None,
                        help="logical mesh axes, e.g. data=8 or "
                             "pipe=4,data=2 (default: resource spec / "
                             "local device count)")
    parser.add_argument("--resource-spec", default=None,
                        help="resource spec yaml (mesh hint + hbm_gb "
                             "budget)")
    parser.add_argument("--budget-gb", type=float, default=None,
                        help="per-device HBM budget in GiB (overrides "
                             "the spec)")
    parser.add_argument("--overlap", default=None,
                        help="stamp this overlap schedule mode (auto | "
                             "none | pipeline | ring | full) onto every "
                             "AllReduce node before analyzing — lint a "
                             "schedule request against the mesh "
                             "(docs/overlap.md)")
    parser.add_argument("--elastic-from", default=None, metavar="AXES",
                        help="validate an ELASTIC RESUME: the checkpoint "
                             "was written at these mesh axes (e.g. "
                             "data=8) and resumes at --mesh — runs the "
                             "elastic/* rules plus the normal passes on "
                             "the new mesh (ring degeneracy re-check, "
                             "HBM at the new 1/M)")
    parser.add_argument("--numerics", default=None, metavar="SPEC",
                        help="stamp a numerics-guard config onto the "
                             "program before analyzing (docs/numerics.md)"
                             ": 'on'/'off', an on_nonfinite policy "
                             "(skip|raise|rollback), or comma-separated "
                             "fields like 'loss_scale=1e36,clip_norm=1' "
                             "— lint loss scaling against quantizing "
                             "compressors (numerics/* rules)")
    parser.add_argument("--passes", default=None,
                        help="comma-separated subset of passes "
                             "(default: all)")
    parser.add_argument("--dump-ir", nargs="?", const="json",
                        choices=("json", "dot"), default=None,
                        metavar="FORMAT",
                        help="emit the sync-schedule IR this plan lowers "
                             "to (docs/schedule-ir.md) instead of the "
                             "diagnostics table: 'json' (default) or "
                             "'dot' for a Graphviz dep-graph view; the "
                             "printed JSON carries the schedule_fingerprint "
                             "telemetry and checkpoints stamp")
    parser.add_argument("--watermark", action="store_true",
                        help="emit the schedule's liveness-based HBM "
                             "watermark (docs/analysis.md): walk the "
                             "sync-schedule IR in topological order, "
                             "open/close buffer live intervals, and "
                             "report per-device peak bytes, the leg at "
                             "the peak, and per-microbatch-slot peaks "
                             "on top of the static params+optimizer "
                             "base.  Combines with --dump-ir json "
                             "(one JSON object with schedule_ir + "
                             "watermark keys); exits 1 when a budget "
                             "(--budget-gb / the spec's hbm_gb) is "
                             "exceeded")
    parser.add_argument("--simulate", default=None, metavar="SWEEP",
                        help="sweep mesh shape x slice count x DCN "
                             "bandwidth over the pure cost/watermark "
                             "model (docs/strategies.md 'Two-tier sync "
                             "and --simulate'): SWEEP is a JSON file or "
                             "an inline spec like "
                             "'mesh=data=1024;slices=1,2,4;dcn=25,100"
                             ";hbm=32'.  Per point, per sync mode "
                             "(flat/hier/hier_int8): predicted step "
                             "time, exposed wire per tier, watermark "
                             "HBM, goodput under preemption.  Nothing "
                             "traces or compiles; exits 1 when any "
                             "point exceeds the HBM budget")
    parser.add_argument("--search-report", action="store_true",
                        help="run the leg-calibrated strategy search "
                             "(docs/strategies.md 'Search') on the model "
                             "and dump the top-K candidates with their "
                             "per-leg-kind cost breakdown plus the "
                             "legality rule that pruned each rejected "
                             "branch; the strategy argument is ignored.  "
                             "Constants come from the discovered "
                             "calibration.json (AUTODIST_CALIBRATION / "
                             "AUTODIST_TELEMETRY_DIR) when present")
    parser.add_argument("--topk", type=int, default=5, metavar="K",
                        help="candidates to show in --search-report "
                             "(default 5)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON")
    parser.add_argument("--warn-as-error", action="store_true",
                        help="exit nonzero on WARN findings too")
    parser.add_argument("--list-models", action="store_true")
    parser.add_argument("--list-rules", action="store_true",
                        help="print each pass's rule documentation")
    args = parser.parse_args(argv)

    if args.list_models:
        for name in sorted(_demo_models()):
            print(name)
        return 0
    if args.list_rules:
        from autodist_tpu_torch.analysis import analyzer
        analyzer._load_passes()
        for name in analyzer.PASS_ORDER:
            fn = analyzer.PASS_REGISTRY[name]
            print(f"== pass: {name} ==")
            print((sys.modules[fn.__module__].__doc__ or "").strip())
            print()
        return 0
    if not args.model or (not args.strategy and not args.search_report):
        parser.error("model and strategy are required "
                     "(or use --list-models / --list-rules / "
                     "--search-report, which needs only the model)")

    from autodist_tpu_torch.analysis import analyze
    from autodist_tpu_torch.resource_spec import ResourceSpec

    axes = _parse_mesh(args.mesh) if args.mesh else None
    resource_spec = None
    if args.resource_spec:
        resource_spec = ResourceSpec(args.resource_spec)
    if axes is None and resource_spec is None:
        import torch
        axes = {"data": torch.cuda.device_count() or 1}

    # Builders need a resource spec; fabricate a single-node one sized to
    # the mesh when none was given (pure analysis — nothing launches).
    if resource_spec is None:
        import math
        chips = math.prod(axes.values())
        resource_spec = ResourceSpec(resource_info={
            "nodes": [{"address": "localhost", "chips": chips}],
            "mesh": dict(axes)})

    graph_item = _build_graph_item(args.model)
    if args.numerics:
        graph_item.numerics = _parse_numerics(args.numerics)

    if args.search_report:
        from autodist_tpu_torch.analysis.search import (
            format_search_report,
            search_report,
        )
        report = search_report(graph_item, resource_spec, axes=axes,
                               top_k=args.topk)
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(format_search_report(report))
        return 0 if report.get("best") else 1

    if args.simulate:
        import autodist_tpu_torch.strategy as S
        from autodist_tpu_torch.analysis.simulate import (
            format_sweep_report,
            parse_sweep_spec,
            run_sweep,
        )
        from autodist_tpu_torch.telemetry.calibration import (
            load_default_calibration,
        )

        try:
            config = parse_sweep_spec(args.simulate)
        except ValueError as e:
            raise SystemExit(str(e))
        if args.budget_gb and "hbm_gb" not in config:
            config["hbm_gb"] = float(args.budget_gb)
        builder_cls = getattr(S, args.strategy, None)
        if builder_cls is None or not (
                isinstance(builder_cls, type)
                and issubclass(builder_cls, S.StrategyBuilder)):
            raise SystemExit(
                f"--simulate needs a builder class name, got "
                f"{args.strategy!r}")

        def make_strategy(spec, hier):
            builder = builder_cls(hier=True) if hier else builder_cls()
            return builder.build(graph_item, spec)

        report = run_sweep(graph_item, make_strategy, config,
                           constants=load_default_calibration())
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(format_sweep_report(report))
        priced_any = any("best_mode" in p for p in report["points"])
        if report["n_over_hbm"] or not priced_any:
            return 1
        return 0

    strategy = _build_strategy(args.strategy, graph_item, resource_spec)
    if args.overlap:
        from autodist_tpu_torch.strategy.base import \
            AllReduceSynchronizerConfig
        for node in strategy.node_config:
            if isinstance(node.synchronizer, AllReduceSynchronizerConfig):
                node.synchronizer.overlap = args.overlap
    budget = int(args.budget_gb * (1 << 30)) if args.budget_gb else None
    passes = tuple(p.strip() for p in args.passes.split(",")) \
        if args.passes else None
    elastic = {"from_axes": _parse_mesh(args.elastic_from)} \
        if args.elastic_from else None

    if args.dump_ir or args.watermark:
        # Build the plan projection (legality lowering) and emit the
        # schedule IR it lowers to and/or its liveness watermark — no
        # diagnostics table, exit 0 unless the projection itself cannot
        # be built (or --watermark finds a budget exceeded).
        from autodist_tpu_torch.analysis import analyzer as _an
        from autodist_tpu_torch.analysis.schedule import ir_for
        _an._load_passes()
        strategy_r, compiled, axes_r = _an._resolve_axes(
            strategy, axes, resource_spec)
        ctx = _an.AnalysisContext(strategy=strategy_r,
                                  graph_item=graph_item, axes=axes_r,
                                  compiled=compiled,
                                  resource_spec=resource_spec)
        _an.PASS_REGISTRY["legality"](ctx)
        ir = ir_for(ctx)
        if ir is None:
            print("no synced variables: the plan lowers to an empty "
                  "schedule", file=sys.stderr)
            return 1
        wm = None
        eff_budget = budget or getattr(resource_spec,
                                       "hbm_bytes_per_chip", None)
        if args.watermark:
            from autodist_tpu_torch.analysis import dataflow
            from autodist_tpu_torch.analysis import memory as _mem
            base = _mem._param_and_grad_bytes(ctx)["params"] \
                + (_mem._opt_state_bytes(ctx) or 0.0) \
                + (_mem._activation_bytes(ctx) or 0.0)
            wm = dataflow.watermark(ir, base_bytes=int(base))
            if wm is None:
                print("schedule is unexecutable (dep cycle): no "
                      "topological order to simulate", file=sys.stderr)
                return 1
        if args.dump_ir == "dot":
            print(ir.to_dot())
            if wm is not None:
                print(wm.summary(), file=sys.stderr)
        elif args.dump_ir:
            if wm is not None:
                print(json.dumps({"schedule_ir": ir.to_dict(),
                                  "watermark": wm.to_dict()}, indent=1))
            else:
                print(ir.to_json(indent=1))
        elif wm is not None:
            if args.json:
                print(json.dumps(wm.to_dict(), indent=1))
            else:
                mib = float(1 << 20)
                print(f"schedule watermark [{ir.fingerprint()}]: "
                      f"{wm.summary()}")
                for buf, n in wm.top_buffers():
                    print(f"  {buf:40s} {n / mib:8.2f} MiB")
                if eff_budget:
                    verdict = "EXCEEDED" if wm.peak_bytes > eff_budget \
                        else "ok"
                    print(f"  budget {eff_budget / mib:.1f} MiB: "
                          f"{verdict}")
        if wm is not None and eff_budget and wm.peak_bytes > eff_budget:
            return 1
        return 0

    report = analyze(strategy, graph_item, mesh=axes,
                     resource_spec=resource_spec, budget_bytes=budget,
                     passes=passes, elastic=elastic)

    if args.json:
        print(json.dumps(report.to_dict(), indent=1))
    else:
        print(report.format_table())
    if report.has_errors():
        return 1
    if args.warn_as_error and report.warnings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
