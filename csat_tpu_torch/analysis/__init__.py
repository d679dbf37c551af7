"""csat-lint over the port: PyTorch-aware static analysis of
``csat_tpu_torch/`` and ``chip_smoke.py``.

The JAX package's linter (``csat_tpu/analysis``) with its rule machinery
copied as it is and its manifests written for the port's tree.  The
serving stack promises invariants — zero device syncs on the trace path,
no untracked compiles, layer boundaries with no private reach-through,
structured-fallback-never-raise fault paths, seed and clock discipline —
and each is a named, registered rule over the port's ASTs:

* ``csat_tpu_torch/analysis/manifests.py`` — the declarative layer:
  boundary file sets, hot-path roots, fault-path scopes, the sync,
  compile and random-draw vocabularies of PyTorch.
* ``csat_tpu_torch/analysis/core.py`` — findings, the rule registry,
  inline suppressions (``# csat-lint: disable=<rule>  reason`` — every
  suppression must carry a reason), and the runner.
* one module per rule family: ``boundary`` / ``hotpath`` / ``compiles``
  / ``rng`` / ``faultflow`` / ``clock``.

Run it as ``python -m csat_tpu_torch.cli lint`` (human or ``--format
json`` output; exits nonzero on unsuppressed findings) or through
:func:`csat_tpu_torch.analysis.run_lint`.  ``tests/test_torch_analysis.py``
keeps the port clean and proves every rule still fires on planted
violations.
"""

from csat_tpu_torch.analysis.core import (  # noqa: F401
    Finding, LintReport, Repo, all_rules, run_lint)
from csat_tpu_torch.analysis.manifests import (  # noqa: F401
    BOUNDARIES, LINT_TARGETS)
