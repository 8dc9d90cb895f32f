"""Plan rules: the hierarchical-topology rules (ADT060, ADT061), the
reshard compatibility lint (ADT070, ADT071) and the supervision lint
(ADT080 to ADT082).

The port's copy of those rules of ``autodist_tpu/analysis/plan_rules.py``,
with the same codes, messages and ``where`` fields.  A manifest leaf's
port-only ``split`` field (where the ranks' parts lie) plays no part in
compatibility: the lint compares logical shapes and dtypes.

:func:`lint_plan` runs every rule registered in :data:`PLAN_RULES` over
a (possibly hand-edited) strategy before it lowers; each rule is a
generator over :class:`PlanContext` that reports and never raises.  The
port registers the two rules of the ``dcn`` axis; the rest of the JAX
package's plan rules come with the simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, LintReport


@dataclasses.dataclass
class PlanContext:
    """Everything a plan rule may consult (JAX ``PlanContext``)."""

    strategy: object

    @property
    def graph(self):
        return self.strategy.graph_config

    @property
    def parallel(self) -> dict:
        return self.strategy.graph_config.parallel or {}


PLAN_RULES = []


def plan_rule(fn):
    PLAN_RULES.append(fn)
    return fn


@plan_rule
def rule_dcn_axis_misuse(ctx: PlanContext):
    """The dcn axis joins slices (nodes) over the slow network: it may
    carry only data-parallel gradient sync.  A partitioner record that
    shards a *variable* over ``dcn`` puts model or pipeline collectives
    on the slow level, so a hand-edited one is almost certainly a
    mistake."""
    for nc in ctx.strategy.node_configs:
        part = nc.partitioner
        if part is None:
            continue
        spec_hits = False
        for entry in (part.spec or []):
            leaves = entry if isinstance(entry, (list, tuple)) else [entry]
            if const.DCN_AXIS in [a for a in leaves if a]:
                spec_hits = True
                break
        if not spec_hits and not (part.spec is None
                                  and part.mesh_axis == const.DCN_AXIS
                                  and part.num_shards > 1):
            continue
        yield Diagnostic(
            "ADT060",
            "partitioner shards this variable over the cross-slice "
            "'dcn' axis; DCN carries only data-parallel sync — keep "
            "tensor/pipeline sharding within a slice",
            where=nc.var_name,
            fix="shard over 'model'/'pipe' (ici axes) and leave 'dcn' "
                "to the data-parallel replica set")


@plan_rule
def rule_expert_over_dcn(ctx: PlanContext):
    """Expert sharding across the slice boundary is legal, but every
    dispatch/combine ``all_to_all`` then rides the slow inter-slice
    links, so it warns rather than errors."""
    if ctx.graph.lowering != "expert":
        return
    if ctx.parallel.get("expert_over_dcn"):
        yield Diagnostic(
            "ADT061",
            "expert axis spans the cross-slice DCN boundary: every "
            "dispatch/combine all_to_all pays inter-slice bandwidth "
            "and latency (the hierarchical cost model prices this; "
            "elect it only when the numbers say so)",
            where="parallel.expert_over_dcn",
            fix="keep the expert axis within a slice unless the "
                "priced across-DCN placement wins on this topology")


def lint_plan(strategy) -> LintReport:
    """Every rule of :data:`PLAN_RULES` over ``strategy`` (JAX
    ``lint_plan``)."""
    ctx = PlanContext(strategy=strategy)
    report = LintReport()
    for rule in PLAN_RULES:
        report.extend(rule(ctx))
    return report.sorted()


def sync_rows_transferable(source: dict, target: dict) -> bool:
    """Whether compressor error-feedback rows move verbatim: the same
    layout (rows x width) and the same compressor (a family that did
    not record it, ``"unknown"``, gates on layout alone)."""
    if source["rows"] != target["rows"] \
            or source["width"] != target["width"]:
        return False
    s, t = source.get("compressor"), target.get("compressor")
    return s == t or "unknown" in (s, t)


def lint_reshard(source_manifest: dict, target_manifest: dict) -> LintReport:
    """Check two state-codec manifests for reshard compatibility before
    any data moves: the trees must agree leaf for leaf on logical shape
    and dtype (ADT070, an error naming the leaf); error-feedback rows
    that cannot transfer are an ADT071 warning (the target re-seeds
    them)."""
    report = LintReport()
    src = source_manifest.get("leaves", {})
    dst = target_manifest.get("leaves", {})
    src_sync = set(source_manifest.get("sync", {}))
    dst_sync = set(target_manifest.get("sync", {}))
    fix = ("the reshard engine moves state between layouts of the SAME "
           "(trainable, optimizer); rebuild the target from the same "
           "model, or restore params-only via restore_portable")
    for path in sorted(set(src) - set(dst) - src_sync):
        report.extend([Diagnostic(
            "ADT070", "source state leaf has no counterpart in the "
            "target layout", where=path, fix=fix)])
    for path in sorted(set(dst) - set(src) - dst_sync):
        report.extend([Diagnostic(
            "ADT070", "target state leaf has no counterpart in the "
            "source layout", where=path, fix=fix)])
    for path in sorted(set(src) & set(dst)):
        if path in src_sync or path in dst_sync:
            continue
        s, d = src[path], dst[path]
        if list(s["logical_shape"]) != list(d["logical_shape"]):
            report.extend([Diagnostic(
                "ADT070",
                f"logical shape {s['logical_shape']} (source) != "
                f"{d['logical_shape']} (target)", where=path, fix=fix)])
        if s["dtype"] != d["dtype"]:
            report.extend([Diagnostic(
                "ADT070",
                f"dtype {s['dtype']} (source) != {d['dtype']} (target)",
                where=path, fix=fix)])
    for path in sorted(src_sync | dst_sync):
        s = source_manifest.get("sync", {}).get(path)
        d = target_manifest.get("sync", {}).get(path)
        if s is None or d is None or not sync_rows_transferable(s, d):
            report.extend([Diagnostic(
                "ADT071",
                "error-feedback rows change layout across this reshard "
                f"(source {s}, target {d}); the target re-seeds them "
                "from the compressor's init state", where=path,
                fix="expect a short re-warm of the error-feedback "
                    "residuals; trajectories stay convergent but are "
                    "not bit-identical through the switch")])
    return report.sorted()


def _max_ssp_staleness(strategy) -> int:
    """The largest SSP staleness a synchronizer of the plan declares."""
    if strategy is None:
        return 0
    return max((int(getattr(nc.synchronizer, "staleness", 0) or 0)
                for nc in strategy.node_configs), default=0)


def lint_supervision(config, strategy: Optional[object] = None
                     ) -> LintReport:
    """Check a :class:`~autodist_tpu_torch.runtime.cluster
    .SupervisionConfig` (or its ``to_dict``) before any worker is
    launched: ADT080 (escalation with no saver), ADT081 (heartbeat
    interval at or past the timeout), ADT082 (the restart backoff's
    worst case outlasts the SSP window of ``strategy``)."""
    from autodist_tpu_torch.runtime.retry import RetryPolicy

    d = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    report = LintReport()
    if d.get("escalate") and not d.get("has_saver"):
        report.extend([Diagnostic(
            "ADT080",
            "escalate=True but no saver attached: the survivor set "
            "would re-elect and resume with NO checkpoint to restore — "
            "all training state silently lost",
            where="supervision.saver",
            fix="pass saver=Saver(ckpt_dir) in the SupervisionConfig "
                "(the store ElasticController.resume restores from)")])
    interval = d.get("heartbeat_interval_s")
    timeout = d.get("heartbeat_timeout_s")
    if interval is not None and timeout is not None and interval >= timeout:
        report.extend([Diagnostic(
            "ADT081",
            f"heartbeat_interval_s={interval} >= "
            f"heartbeat_timeout_s={timeout}: a healthy worker's counter "
            "looks stalled between two scheduled beats",
            where="supervision.heartbeat_interval_s",
            fix="keep the interval well under the timeout (3-5 beats "
                "per timeout window absorbs scheduler jitter)")])
    stale = _max_ssp_staleness(strategy)
    backoff = d.get("restart_backoff") or {}
    if stale > 0 and backoff:
        try:
            policy = config.restart_backoff if hasattr(
                config, "restart_backoff") else RetryPolicy(**backoff)
            worst = policy.max_total_delay_s()
        except (TypeError, ValueError):
            worst = None
        window = stale * float(d.get("step_time_estimate_s", 1.0) or 1.0)
        if worst is not None and worst > window:
            report.extend([Diagnostic(
                "ADT082",
                f"worst-case restart backoff {worst:.1f}s exceeds the "
                f"SSP staleness window {window:.1f}s "
                f"(staleness={stale}): every peer stalls at the SSP "
                "gate for the overhang on each restart",
                where="supervision.restart_backoff",
                fix="lower cap_delay_s/max_attempts, or raise the SSP "
                    "staleness so a restarting worker fits the window")])
    return report.sorted()
