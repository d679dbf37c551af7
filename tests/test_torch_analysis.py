"""csat-lint over the port (``csat_tpu_torch/analysis``) — rule semantics in
PyTorch's vocabulary, suppressions, drills, the live gate and the CLI.

The JAX package's ``tests/test_analysis.py`` re-expressed at the port's
manifest paths, all pure AST work (no device code runs):

* **Fixture corpus** — for every rule family: one true positive the rule
  must flag, one near-miss negative it must NOT flag, and one suppressed
  case (the positive plus an inline ``# csat-lint: disable=<rule>  reason``)
  that lands in ``report.suppressed``.  Fixtures are tiny synthetic repos
  written under ``tmp_path`` at the port's manifest paths, so the real
  manifests scope them.
* **Seeded-violation drills** — each LIVE boundary file of the port copied
  into a temp root with a private reach-through appended; the rule must
  catch exactly the planted line.
* **Live gate** — ``run_lint`` over this checkout's port comes back clean
  (zero unsuppressed findings, every suppression reasoned), with the
  sites the port carries suppressions at.
"""

import json
import pathlib
import textwrap

import pytest

from csat_tpu_torch.analysis import BOUNDARIES, Repo, all_rules, run_lint
from csat_tpu_torch.analysis.boundary import injector_ctor_calls, injector_ctor_params
from csat_tpu_torch.analysis.cli import main as lint_main

ROOT = pathlib.Path(__file__).resolve().parent.parent

FAULTS_FIXTURE = {
    "csat_tpu_torch/resilience/faults.py": """
        class FaultInjector:
            def __init__(self, on_step=None, on_save=None):
                self.on_step = on_step
                self.on_save = on_save
        """,
}

ENGINE_REL = "csat_tpu_torch/serve/engine.py"


def make_repo(root, files):
    """Write ``{rel: source}`` under ``root`` and return it as a str."""
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


# ---------------------------------------------------------------------------
# fixture corpus: per rule — true positive / near-miss negative / suppressed
# ---------------------------------------------------------------------------

CASES = {
    "private-reach": dict(
        positive={"csat_tpu_torch/serve/fleet.py": """
            def drain(engine):
                return engine._queue
            """},
        negative={"csat_tpu_torch/serve/fleet.py": """
            class Fleet:
                def __init__(self):
                    self._replicas = []

                def drain(self, engine):
                    n = engine.queue_depth() + len(self._replicas)
                    return n, engine.__class__.__name__
            """},
        suppressed={"csat_tpu_torch/serve/fleet.py": """
            def drain(engine):
                return engine._queue  # csat-lint: disable=private-reach test seam for the drill harness
            """},
    ),
    "legacy-kernel-import": dict(
        positive={"csat_tpu_torch/ops/old_bench.py": """
            import csat_tpu_torch.ops.sbm_pallas as sp
            """},
        negative={"csat_tpu_torch/ops/new_bench.py": """
            from csat_tpu_torch.ops import flex_core
            import csat_tpu_torch.ops.sbm_pallas_shim  # CONTAINS a legacy name, is not one
            """},
        suppressed={"csat_tpu_torch/ops/old_bench.py": """
            import csat_tpu_torch.ops.cse_pallas  # csat-lint: disable=legacy-kernel-import archival A/B harness
            """},
    ),
    "backend-literal": dict(
        positive={
            "csat_tpu_torch/models/pick.py": """
                from csat_tpu_torch.ops.flex_core import select_impl

                def pick(x):
                    if select_impl(x) == "kernel":
                        return 1
                    return 0
                """,
            "csat_tpu_torch/serve/pick.py": """
                def impl(x):
                    return "kernel" if x.is_cuda else "reference"
                """,
        },
        negative={
            "csat_tpu_torch/models/pick.py": '''
                """Routes ("kernel" included) dispatch via select_impl."""

                def pick(x, flex_attention):
                    "kernel"
                    return flex_attention(x)
                ''',
            "csat_tpu_torch/serve/pick.py": '''
                """serve/ reaches the "kernel" route through the ops too."""

                def impl(x, paged_attend):
                    return paged_attend(x)
                ''',
        },
        suppressed={"csat_tpu_torch/models/pick.py": """
            ROUTES = ("kernel",)  # csat-lint: disable=backend-literal doc table of valid routes, not a branch
            """},
    ),
    "mesh-axis-literal": dict(
        positive={ENGINE_REL: """
            def head_group(mesh):
                return mesh.axis("model").group
            """},
        negative={ENGINE_REL: '''
            """Pages shard on the "model" axis; names live in mesh.py."""
            from csat_tpu_torch.parallel.mesh import HEAD_AXIS

            def head_group(mesh):
                kind = "models"   # CONTAINS an axis name, is not one
                stage = "pipeline"
                return mesh.axis(HEAD_AXIS).group, kind, stage
            '''},
        suppressed={ENGINE_REL: """
            AXES = ("data", "model")  # csat-lint: disable=mesh-axis-literal doc table of the axis vocabulary
            """},
    ),
    "injector-ctor-kwargs": dict(
        positive={**FAULTS_FIXTURE, "csat_tpu_torch/resilience/chaos.py": """
            from csat_tpu_torch.resilience.faults import FaultInjector

            def apply(boom):
                return FaultInjector(on_boom=boom)
            """},
        negative={**FAULTS_FIXTURE, "csat_tpu_torch/resilience/chaos.py": """
            from csat_tpu_torch.resilience.faults import FaultInjector

            def apply(f, g):
                return FaultInjector(on_step=f, on_save=g)
            """},
        suppressed={**FAULTS_FIXTURE, "csat_tpu_torch/resilience/chaos.py": """
            from csat_tpu_torch.resilience.faults import FaultInjector

            def apply(boom):
                return FaultInjector(on_boom=boom)  # csat-lint: disable=injector-ctor-kwargs hook lands next
            """},
    ),
    "host-sync": dict(
        positive={
            "csat_tpu_torch/obs/rtrace.py": """
                def span_end(t):
                    return t.item()
                """,
            # a zero-sync module: even a host copy of the token list is off-contract
            "csat_tpu_torch/serve/netclient.py": """
                def decode(frame):
                    return frame["tokens"].tolist()
                """,
            # the front door's hot graph: a sync in a helper reached from step()
            "csat_tpu_torch/serve/netfront.py": """
                import torch

                class NetFront:
                    def step(self):
                        return self._pump()

                    def _pump(self):
                        torch.cuda.synchronize()
                        return len(self.conns)
                """,
        },
        negative={
            "csat_tpu_torch/obs/rtrace.py": """
                def span_end(spans, arr):
                    # dict .items() is not .item(); .item(i) with an arg is indexing
                    return sorted(spans.items()), arr.item(0)
                """,
            "csat_tpu_torch/serve/netclient.py": """
                def decode(frame):
                    return [int(t) for t in frame["tokens"]]
                """,
            "csat_tpu_torch/serve/netfront.py": """
                class NetFront:
                    def step(self):
                        return len(self.conns)

                    def debug_probe(self, t):
                        # unreachable from step/drain: off the hot graph
                        return t.item()
                """,
        },
        suppressed={
            "csat_tpu_torch/obs/rtrace.py": """
                def span_end(t):
                    return t.item()  # csat-lint: disable=host-sync trace self-test reads its own fixture
                """,
            "csat_tpu_torch/serve/netclient.py": """
                def decode(frame):
                    return frame["tokens"].tolist()  # csat-lint: disable=host-sync golden-frame self-test
                """,
        },
    ),
    "untracked-compile": dict(
        positive={"csat_tpu_torch/train/sweep.py": """
            import torch

            def run(fns):
                outs = []
                for f in fns:
                    outs.append(torch.compile(f))
                return outs
            """},
        negative={"csat_tpu_torch/train/sweep.py": """
            import torch

            def run(f, xs):
                g = torch.compile(f)
                return [g(x) for x in xs]
            """},
        suppressed={"csat_tpu_torch/train/sweep.py": """
            import torch

            def run(fns):
                outs = []
                for f in fns:
                    outs.append(torch.compile(f))  # csat-lint: disable=untracked-compile compile-storm microbench
                return outs
            """},
    ),
    "rng-reuse": dict(
        positive={"csat_tpu_torch/ops/noise.py": """
            from csat_tpu_torch.ops.hashrng import uniform_field

            def draw(seed, b, h, n, stride):
                a = uniform_field(seed, b, h, n, n, stride)
                d = uniform_field(seed, b, h, n, n, stride)
                return a, d
            """},
        negative={"csat_tpu_torch/ops/noise.py": """
            from csat_tpu_torch.ops.hashrng import uniform_field

            def draw(sseed, dseed, b, h, n, stride):
                a = uniform_field(sseed, b, h, n, n, stride)
                d = uniform_field(dseed, b, h, n, n, stride)
                return a, d
            """},
        suppressed={"csat_tpu_torch/ops/noise.py": """
            from csat_tpu_torch.ops.hashrng import uniform_field

            def draw(seed, b, h, n, stride):
                a = uniform_field(seed, b, h, n, n, stride)
                d = uniform_field(seed, b, h, n, n, stride)  # csat-lint: disable=rng-reuse replay is this test's subject
                return a, d
            """},
    ),
    "rng-implicit": dict(
        positive={"csat_tpu_torch/train/noise.py": """
            import torch

            def noise(shape):
                return torch.rand(shape)
            """},
        negative={"csat_tpu_torch/train/noise.py": """
            import numpy as np
            import torch

            def noise(shape, gen, seed):
                rng = np.random.default_rng(seed)
                x = torch.empty(shape).uniform_(generator=gen)
                return torch.rand(shape, generator=gen) + x, rng.permutation(4)
            """},
        suppressed={"csat_tpu_torch/train/noise.py": """
            import torch

            def noise(shape):
                return torch.rand(shape)  # csat-lint: disable=rng-implicit draws the global stream on purpose
            """},
    ),
    "swallowed-fault": dict(
        positive={
            "csat_tpu_torch/serve/pool.py": """
                def reap(worker):
                    try:
                        worker.join()
                    except Exception:
                        pass
                """,
            "csat_tpu_torch/serve/netfront.py": """
                def read_lines(conn):
                    try:
                        return conn.sock.recv(65536)
                    except Exception:
                        conn.buf = b""
                """,
        },
        negative={
            "csat_tpu_torch/serve/pool.py": """
                def reap(worker, obs):
                    try:
                        worker.join()
                    except TimeoutError:
                        pass  # narrow catch: out of the rule's scope
                    try:
                        worker.close()
                    except Exception as e:
                        obs.emit("reap_failed", err=str(e))
                """,
            "csat_tpu_torch/serve/netfront.py": """
                def read_lines(self, conn):
                    try:
                        return conn.sock.recv(65536)
                    except Exception:
                        self._net_stall_drop(conn)
                """,
        },
        suppressed={
            "csat_tpu_torch/serve/pool.py": """
                def reap(worker):
                    try:
                        worker.join()
                    except Exception:  # csat-lint: disable=swallowed-fault shutdown path, nothing left to tell
                        pass
                """,
            "csat_tpu_torch/serve/netfront.py": """
                def close_conn(conn):
                    try:
                        conn.sock.close()
                    except Exception:  # csat-lint: disable=swallowed-fault socket already dead on teardown
                        pass
                """,
        },
    ),
    "wall-clock": dict(
        positive={"csat_tpu_torch/serve/backoff.py": """
            import time

            def expired(last, ttl):
                return time.time() - last > ttl
            """},
        negative={"csat_tpu_torch/serve/backoff.py": """
            import time

            def stamp(extra):
                return {"ts": time.time(), "t3": round(time.time(), 3)}
            """},
        suppressed={"csat_tpu_torch/serve/backoff.py": """
            import time

            def expired(last, ttl):
                return time.time() - last > ttl  # csat-lint: disable=wall-clock cert expiry is epoch math
            """},
    ),
}


@pytest.mark.parametrize("kind", ["positive", "negative", "suppressed"])
@pytest.mark.parametrize("rule", sorted(CASES))
def test_fixture_corpus(tmp_path, rule, kind):
    report = run_lint(make_repo(tmp_path, CASES[rule][kind]), rules=[rule])
    hits = [f for f in report.findings if f.rule == rule]
    if kind == "positive":
        assert hits, f"{rule}: planted violation not caught\n" + report.format()
        # every planted file of the positive case is caught
        assert {f.path for f in hits} == set(CASES[rule][kind]) - set(FAULTS_FIXTURE)
    elif kind == "negative":
        assert report.clean, f"{rule}: near-miss flagged\n" + report.format()
    else:
        assert report.clean, f"{rule}: reasoned suppression not honored\n" + report.format()
        assert [f for f in report.suppressed if f.rule == rule]


def test_every_rule_family_is_registered():
    assert set(CASES) == set(all_rules())


# ---------------------------------------------------------------------------
# the port's vocabulary: scopes, hot graph, compiles, seeds, draws
# ---------------------------------------------------------------------------

def _findings(tmp_path, files, rule):
    return run_lint(make_repo(tmp_path, files), rules=[rule]).findings


HOT_GRAPH = [
    # (engine source, rule, findings): float() on a device tensor in a helper of tick
    ("""
     import torch

     class ServeEngine:
         def tick(self):
             return self._score()

         def _score(self):
             x = torch.ones(3)
             return float(x)
     """, "host-sync", 1),
    # the declared cold boundaries stop the traversal
    ("""
     import torch

     class ServeEngine:
         def tick(self):
             self._rebuild_and_resubmit(None)
             self._warm_libraries()

         def _rebuild_and_resubmit(self, exc):
             torch.cuda.synchronize()

         def _warm_libraries(self):
             self.flag.item()
     """, "host-sync", 0),
    # host copies are legal on the engine's hot graph, as JAX's np.asarray
    ("""
     class ServeEngine:
         def tick(self):
             self._status = self._flags.cpu().numpy().tolist()
     """, "host-sync", 0),
    # a library load on the hot graph without a cache-miss guard
    ("""
     from csat_tpu_torch.ops import build

     class ServeEngine:
         def tick(self):
             self._lib = build.load_library("paged_decode")
     """, "untracked-compile", 1),
    ("""
     import torch

     class ServeEngine:
         def tick(self, f):
             if self._prog is None:
                 self._prog = torch.compile(f)
             return self._prog
     """, "untracked-compile", 0),
    ("""
     import torch

     class ServeEngine:
         def tick(self, f):
             with torch.cuda.graph(self._graph):
                 f()
     """, "untracked-compile", 1),
]


@pytest.mark.parametrize("src,rule,n", HOT_GRAPH, ids=range(len(HOT_GRAPH)))
def test_engine_hot_graph(tmp_path, src, rule, n):
    assert len(_findings(tmp_path, {ENGINE_REL: src}, rule)) == n


def test_zero_sync_scope_bans_copies_and_torch(tmp_path):
    found = _findings(tmp_path, {"csat_tpu_torch/obs/slo.py": """
        import torch

        def burn(window):
            return window.cpu(), window.numpy(), torch.as_tensor(window), torch.mean(window)
        """}, "host-sync")
    assert len(found) == 4, found


def test_library_builds_in_a_loop(tmp_path):
    found = _findings(tmp_path, {"csat_tpu_torch/ops/warm.py": """
        from csat_tpu_torch.ops import build

        def warm(names):
            for name in names:
                build.load_library(name)
            build.build_all(names)
        """}, "untracked-compile")
    assert [f.line for f in found] == [6]


SEEDS = [
    # a seed defined outside the loop feeds the same draw every iteration
    ("""
     def loop(seed, bhs, n, stride):
         out = []
         for bh in bhs:
             out.append(block_uniform(seed, bh, 0, 0, n, n, stride))
         return out
     """, ["every loop iteration"]),
    # a fresh seed each iteration is legal
    ("""
     def loop(gen, bhs, n, stride):
         out = []
         for bh in bhs:
             seed = draw_seed(gen)
             out.append(block_uniform(seed, bh, 0, 0, n, n, stride))
         return out
     """, []),
    # exclusive branches may share a seed
    ("""
     def draw(seed, flip, n):
         if flip:
             return hash_bits(seed, 0, 0, n, 1)
         else:
             return uniform_field(seed, 1, 1, n, n, n)
     """, []),
    # one seed for both streams of a keyed stream, and by keyword
    ("""
     def streams(seed, other):
         a = KeyedStream(seed, seed)
         b = hashrng.KeyedStream(sample_seed=other, dropout_seed=other)
         return a, b
     """, ["already fed", "already fed"]),
]


@pytest.mark.parametrize("src,want", SEEDS, ids=range(len(SEEDS)))
def test_seed_reuse(tmp_path, src, want):
    found = _findings(tmp_path, {"csat_tpu_torch/ops/noise.py": src}, "rng-reuse")
    assert len(found) == len(want) and all(w in f.message for w, f in zip(want, found)), found


def test_implicit_draws(tmp_path):
    found = _findings(tmp_path, {"csat_tpu_torch/data/shuffle.py": """
        import random

        import numpy as np
        import torch

        def shuffle(idx, t, gen, seed):
            np.random.shuffle(idx)
            rng = np.random.default_rng()
            t.normal_()
            u = torch.rand_like(t)
            k = torch.randint(0, 4, (3,))
            random.shuffle(idx)
            torch.nn.init.uniform_(t)
            ok = (np.random.default_rng(seed), random.Random(seed), torch.randperm(4, generator=gen),
                  t.bernoulli_(0.5, generator=gen), torch.nn.init.normal_(t, generator=gen))
            return rng, u, k, ok
        """}, "rng-implicit")
    assert [f.line for f in found] == [8, 9, 10, 11, 12, 13, 14], found


# ---------------------------------------------------------------------------
# suppression machinery (meta rules)
# ---------------------------------------------------------------------------

BACKOFF = "csat_tpu_torch/serve/backoff.py"


def test_reasonless_suppression_is_a_finding_and_does_not_silence(tmp_path):
    report = run_lint(make_repo(tmp_path, {BACKOFF: """
        import time

        def expired(last, ttl):
            return time.time() - last > ttl  # csat-lint: disable=wall-clock
        """}), rules=["wall-clock"])
    assert {f.rule for f in report.findings} == {"wall-clock", "bad-suppression"}
    assert not report.suppressed


@pytest.mark.parametrize("src,want", [
    ("X = 1  # csat-lint: disable=no-such-rule because reasons\n", {"bad-suppression"}),
    ("def f(:\n    pass\n", {"parse-error"}),
])
def test_meta_findings(tmp_path, src, want):
    report = run_lint(make_repo(tmp_path, {BACKOFF: src}), rules=["wall-clock"])
    assert {f.rule for f in report.findings} == want


def test_standalone_comment_suppresses_the_line_below(tmp_path):
    report = run_lint(make_repo(tmp_path, {BACKOFF: """
        import time

        def expired(last, ttl):
            # csat-lint: disable=wall-clock epoch math by contract
            return time.time() - last > ttl
        """}), rules=["wall-clock"])
    assert report.clean and report.suppressed


def test_unknown_rule_name_raises(tmp_path):
    with pytest.raises(KeyError):
        run_lint(make_repo(tmp_path, {BACKOFF: "X = 1\n"}), rules=["no-such-rule"])


# ---------------------------------------------------------------------------
# seeded-violation drills over the port's LIVE boundary files
# ---------------------------------------------------------------------------

DRILL = "\n\ndef _lint_drill(obj):\n    return obj._seeded_violation\n"
BOUNDARY_FILES = [(b.name, rel) for b in BOUNDARIES for rel in b.files]


@pytest.mark.parametrize("layer,rel", BOUNDARY_FILES, ids=[f"{n}:{r}" for n, r in BOUNDARY_FILES])
def test_seeded_reach_through_is_caught(tmp_path, layer, rel):
    planted = tmp_path / rel
    planted.parent.mkdir(parents=True, exist_ok=True)
    planted.write_text((ROOT / rel).read_text() + DRILL)
    report = run_lint(str(tmp_path), rules=["private-reach"])
    assert len(report.findings) == 1, report.format()
    hit = report.findings[0]
    assert hit.path == rel
    assert "_seeded_violation" in planted.read_text().splitlines()[hit.line - 1]


# ---------------------------------------------------------------------------
# the live gate and the CLI
# ---------------------------------------------------------------------------

#: the port's reasoned suppressions: (file, rule) → count
SUPPRESSED = {("csat_tpu_torch/resilience/watchdog.py", "swallowed-fault"): 4,
              ("csat_tpu_torch/serve/warmstart.py", "swallowed-fault"): 2,
              ("csat_tpu_torch/serve/netclient.py", "mesh-axis-literal"): 1,
              ("csat_tpu_torch/serve/netfront.py", "mesh-axis-literal"): 1,
              ("csat_tpu_torch/serve/engine.py", "untracked-compile"): 1}


def test_the_port_lints_clean():
    """Zero unsuppressed findings over ``csat_tpu_torch/`` and
    ``chip_smoke.py``; a reason-less or unknown-rule suppression would be a
    ``bad-suppression`` finding, so clean certifies the suppressions too."""
    report = run_lint(str(ROOT))
    assert report.clean, "\n" + report.format()
    assert report.files > 90
    got = {}
    for f in report.suppressed:
        got[(f.path, f.rule)] = got.get((f.path, f.rule), 0) + 1
    assert got == SUPPRESSED
    repo = Repo(str(ROOT))
    assert injector_ctor_params(repo) and injector_ctor_calls(repo)


def test_cli_exit_codes_and_json(tmp_path, capsys):
    root = make_repo(tmp_path / "bad", CASES["host-sync"]["positive"])
    assert lint_main(["--root", root, "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == {"host-sync"}
    assert len(payload["findings"]) == 3 and payload["files"] == 3
    clean = make_repo(tmp_path / "ok", {"csat_tpu_torch/ok.py": "X = 1\n"})
    assert lint_main(["--root", clean]) == 0
    assert "0 findings" in capsys.readouterr().out
    assert lint_main(["--root", clean, "--rules", "nope"]) == 2
    assert lint_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(rule in listed for rule in CASES)


def test_cli_dispatch(tmp_path, monkeypatch, capsys):
    """``python -m csat_tpu_torch.cli lint ...`` routes to the analyzer."""
    from csat_tpu_torch import cli

    root = make_repo(tmp_path, CASES["wall-clock"]["positive"])
    for rc, argv in ((1, ["lint", "--root", root]),
                     (0, ["lint", "--root", root, "--rules", "host-sync"])):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == rc
    assert "[wall-clock]" in capsys.readouterr().out
