"""Plan lint: the parts the runtime and elasticity layers need.

The port's copies of ``autodist_tpu/analysis``'s :class:`Diagnostic`
and :class:`LintReport` and of these plan rules: the two of the ``dcn``
axis (ADT060, ADT061, through :func:`lint_plan`), the reshard
compatibility lint (ADT070, ADT071) and the supervision lint (ADT080 to
ADT082), with the JAX package's codes, messages and ``where`` fields.
The rest of the linter is ROADMAP Queue 1, item 10.
"""
from autodist_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES, ERROR, INFO, WARNING, Diagnostic, LintReport)
from autodist_tpu_torch.analysis.plan_rules import (  # noqa: F401
    PLAN_RULES, lint_plan, lint_reshard, lint_supervision,
    sync_rows_transferable)
