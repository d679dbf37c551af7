"""The declarative layer behind every csat-lint rule, for the port's tree.

Rules are generic machinery; THIS file is where the port's architecture
is written down.  Each constant answers one question that used to be
answered from memory:

* which files form a bounded layer (no private reach-through)?
* which functions are the serving hot path (no device syncs, no
  untracked compiles)?
* which packages own fault paths (broad excepts must re-raise or emit a
  structured event)?

The invariants are the JAX package's (``csat_tpu/analysis/manifests.py``),
written in PyTorch's idiom: a device sync is ``.item()`` /
``.synchronize()``, a host copy is ``.cpu()`` / ``.numpy()`` / ``.tolist()``,
a compile is ``torch.compile``, a CUDA graph capture or a kernel library
build, and a random stream is the counter hash of ``ops/hashrng.py`` or a
``torch.Generator``.  Growing the system edits these manifests — the rule
implementations should almost never change.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

#: Default lint targets, repo-relative (directories rglob'd for ``*.py``).
LINT_TARGETS: Tuple[str, ...] = ("csat_tpu_torch", "chip_smoke.py")


# ---------------------------------------------------------------------------
# boundary family
# ---------------------------------------------------------------------------

class Boundary(NamedTuple):
    """One bounded layer: ``files`` compose the rest of the system
    strictly through public surfaces — any ``obj._name`` attribute access
    on a non-``self`` object inside them is a reach-through violation."""

    name: str
    files: Tuple[str, ...]
    doc: str


#: The bounded layers.
BOUNDARIES: Tuple[Boundary, ...] = (
    Boundary(
        "fleet",
        ("csat_tpu_torch/serve/fleet.py", "csat_tpu_torch/serve/router.py",
         "csat_tpu_torch/serve/autoscale.py", "csat_tpu_torch/serve/warmstart.py"),
        "fleet/router/autoscaler/warm-start compose ServeEngine through "
        "its public API only — resilience semantics stay inside the "
        "engine, and the fleet survives engine-internal refactors"),
    Boundary(
        "chaos",
        ("csat_tpu_torch/serve/traffic.py", "csat_tpu_torch/resilience/chaos.py",
         "csat_tpu_torch/resilience/invariants.py"),
        "the traffic zoo, FaultPlan compiler and invariant monitors drive "
        "the serve stack through public surfaces — an injector/engine "
        "rename breaks loudly here, not silently at drill time"),
    Boundary(
        "obs",
        ("csat_tpu_torch/obs/rtrace.py", "csat_tpu_torch/obs/slo.py"),
        "the request tracer and SLO burn-rate engine are called INTO by "
        "the serve stack and read registries via MetricsRegistry.get — "
        "they never reach into engine/fleet internals"),
    Boundary(
        "tiering",
        ("csat_tpu_torch/serve/tiering.py",),
        "the tiered KV page store is host-only byte storage keyed by "
        "content hash — it composes nothing of the engine/pool/prefix "
        "internals (the engine drives IT through put/get/drop/clear), "
        "so the store stays testable without a device and reusable "
        "under any pool layout"),
)

#: The JAX package's deleted legacy Pallas kernels: nothing of the port
#: may import a module of these names either.
LEGACY_KERNELS = frozenset(
    {"sbm_pallas", "sbm_flash_pallas", "sbm_fused_pallas", "cse_pallas"})
LEGACY_IMPORT_SCOPE: Tuple[str, ...] = ("csat_tpu_torch/",)

#: ``models/`` and ``serve/`` may not grow backend branches outside the
#: flex-core entry point: ``ops/flex_core.py:select_impl`` is the single
#: dispatch between a kernel and its plain version, so its ``"kernel"``
#: string constant outside a docstring is a violation there.
BACKEND_LITERAL_SCOPE: Tuple[str, ...] = (
    "csat_tpu_torch/models/", "csat_tpu_torch/serve/")
BACKEND_LITERALS = frozenset({"kernel"})

#: Mesh axis names live in ``parallel/mesh.py`` ONLY (``DATA_AXIS`` etc.):
#: a bare axis-name string constant in ``models/`` or ``serve/`` couples
#: model/serving code to one mesh spelling and silently breaks when the
#: serve mesh is renamed or re-shaped.
MESH_AXIS_LITERAL_SCOPE: Tuple[str, ...] = (
    "csat_tpu_torch/models/", "csat_tpu_torch/serve/")
MESH_AXIS_LITERALS = frozenset({"data", "model", "seq", "pipe"})

#: Public-ctor-kwarg check: ``FaultPlan.apply`` (and anything else in the
#: call files) must construct :class:`FaultInjector` with keyword
#: arguments that exist on the ctor — the hook surface is the contract.
INJECTOR_CLASS_FILE = "csat_tpu_torch/resilience/faults.py"
INJECTOR_CLASS_NAME = "FaultInjector"
INJECTOR_CALL_FILES: Tuple[str, ...] = ("csat_tpu_torch/resilience/chaos.py",)


# ---------------------------------------------------------------------------
# hot-path family (host syncs + untracked compiles)
# ---------------------------------------------------------------------------

#: Modules where the invariant is ZERO device interaction of any kind (the
#: trace path reads host clocks only; routing decisions and burn-rate math
#: are pure host work; the streaming client keeps tokens as plain int
#: lists end to end).  Every sync-ish construct is flagged here, including
#: host copies (``.cpu()``, ``np.asarray``, ...) and any ``torch.*`` call.
ZERO_SYNC_MODULES: Tuple[str, ...] = (
    "csat_tpu_torch/obs/rtrace.py", "csat_tpu_torch/obs/slo.py",
    "csat_tpu_torch/serve/router.py", "csat_tpu_torch/serve/netclient.py")

#: Hot-path roots per module: the per-tick / per-request entry points.
#: The analyzer expands these through the module's own call graph
#: (``self.x()`` and module-level calls), so a helper extracted from
#: ``tick`` stays covered without a manifest edit.
HOT_ROOTS: Dict[str, Tuple[str, ...]] = {
    "csat_tpu_torch/serve/engine.py": (
        "ServeEngine.tick", "ServeEngine.submit", "ServeEngine.poll",
        "ServeEngine.pop_result", "ServeEngine.drain"),
    # the network front door's per-iteration socket loop: socket I/O
    # lives BETWEEN engine ticks and must never read a device value onto
    # the host — a sync here would stall every connection
    "csat_tpu_torch/serve/netfront.py": ("NetFront.step", "NetFront.drain"),
}

#: Declared cold exits from the hot graph — traversal stops here.  Each
#: entry carries its justification; a new entry needs the same scrutiny
#: as a suppression.
COLD_BOUNDARIES: Dict[str, str] = {
    "ServeEngine._warm_libraries":
        "kernel library load and warm start: loading is its purpose; each "
        "library is built or restored once per process and its "
        "provenance booked in stats",
    "ServeEngine._rebuild_and_resubmit":
        "the declared device-fault rebuild path: a fresh pool and a "
        "library re-warm are the point, bounded by serve_max_rebuilds "
        "and counted in stats.rebuilds",
}

#: Method/function calls that read a device value onto the host (flagged
#: in every hot scope).
SYNC_ATTR_CALLS = frozenset({"item", "synchronize"})
SYNC_DOTTED_CALLS = frozenset({"torch.cuda.synchronize"})
#: Additionally flagged only in ZERO_SYNC_MODULES, where even building a
#: host copy of an array is off-contract: dotted calls, and zero-argument
#: method calls on any object.
TRANSFER_DOTTED_CALLS = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
     "torch.as_tensor", "torch.tensor", "torch.from_numpy"})
TRANSFER_ATTR_CALLS = frozenset({"cpu", "numpy", "tolist"})

#: Dotted roots whose call results are treated as device tensors by the
#: per-function inference (``x = torch.sum(...)`` ⇒ ``float(x)`` /
#: ``if x:`` are sync findings); in ZERO_SYNC_MODULES any call under them
#: is device work.
DEVICE_ROOTS = frozenset({"torch"})

#: Compile constructors for the untracked-compile rule: ``torch.compile``,
#: CUDA graph capture, and the kernel library build and load of
#: ``ops/build.py`` (imported as ``build`` or by name).
COMPILE_DOTTED_CALLS = frozenset(
    {"torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
     "torch.cuda.make_graphed_callables",
     "build.build_all", "build.load_library", "build.warm_library",
     "build_all", "load_library", "warm_library"})


# ---------------------------------------------------------------------------
# RNG discipline
# ---------------------------------------------------------------------------

#: The counter-hash stream (``ops/hashrng.py``): a pure function of its
#: seed and the draw's indices, so the same seed drawn twice is the same
#: stream twice.  Callee name → the positional indices and keyword names
#: of its seed arguments.
HASH_CONSUMERS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "hash_bits": ((0,), ("seed",)),
    "uniform_field": ((0,), ("seed",)),
    "block_uniform": ((0,), ("seed",)),
    "KeyedStream": ((0, 1), ("sample_seed", "dropout_seed")),
}

#: torch draws that take ``generator=``: without it they read the global
#: generator, the port's counterpart of an implicit key.
TORCH_DRAWS = frozenset(
    {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
     "normal", "poisson"})
#: In-place tensor draws (``x.uniform_(generator=g)``), flagged the same way.
TENSOR_DRAWS = frozenset(
    {"uniform_", "normal_", "bernoulli_", "random_", "exponential_",
     "geometric_", "cauchy_", "log_normal_"})
#: ``torch.*_like`` draws take no generator at all: always the global one.
GLOBAL_TORCH_DRAWS = frozenset({"rand_like", "randn_like", "randint_like"})
#: ``np.random`` attributes that build an explicit generator; any other
#: ``np.random.<fn>(...)`` call draws from (or seeds) numpy's global state.
NUMPY_GENERATOR_MAKERS = frozenset(
    {"default_rng", "Generator", "PCG64", "PCG64DXSM", "Philox", "SFC64",
     "MT19937", "SeedSequence", "RandomState", "BitGenerator"})
#: The stdlib ``random`` module's generator classes; any other
#: ``random.<fn>(...)`` call draws from its global generator.
STDLIB_GENERATORS = frozenset({"Random", "SystemRandom"})


# ---------------------------------------------------------------------------
# fault-path family
# ---------------------------------------------------------------------------

#: Packages whose broad excepts must re-raise or emit a structured
#: event/metric (the structured-fallback-never-raise contract).
#: ``serve/`` covers the tier store (a swallowed restore failure must
#: surface as a ``tier.restore_miss``/``tier.spill``-style event) and the
#: network front door and client (a ``net.*`` event: ``net.malformed``,
#: ``net.stall_drop``, ``net.submit_fail``, ...).
FAULT_SCOPES: Tuple[str, ...] = (
    "csat_tpu_torch/serve/", "csat_tpu_torch/resilience/")

#: Exception names considered "broad" when caught.
BROAD_EXCEPTIONS = frozenset({"Exception", "BaseException"})

#: A broad handler is structured when its body calls something whose
#: name contains one of these markers (obs.emit, stats.record_outcome,
#: self._note_fault, self._finish, self._retire_replica,
#: self._rebuild_and_resubmit, counter.inc, ...) — the vocabulary of
#: "this failure became an event, a metric, or a terminal outcome".
EVENT_MARKERS: Tuple[str, ...] = (
    "emit", "record", "observe", "note", "metric", "event", "postmortem",
    "dump", "trip", "fault", "finish", "resubmit", "retire", "fail",
    "miss", "spill", "log", "warn",
    # net.* protocol outcomes (self._note_malformed, helpers named net_*)
    "net")
#: Exact callee names that also qualify (too short for substring match).
EVENT_MARKER_NAMES = frozenset({"inc"})


# ---------------------------------------------------------------------------
# clock discipline
# ---------------------------------------------------------------------------

#: Wall-clock reads: fine as timestamps in records, a bug the moment the
#: value enters arithmetic or a comparison (backoff, deadlines, watchdog
#: windows, durations) — NTP steps make intervals lie.  Use
#: ``time.monotonic()`` / ``time.perf_counter()`` there.
WALL_CLOCK_CALLS = frozenset({"time.time"})
