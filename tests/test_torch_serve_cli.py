"""Raw code in, summaries out: the port's extractor and ``sample_from_source``
bitwise against the JAX package's on a snippet corpus, the JSONL request
parser on its hardened cases, the burst-tolerant stdin reader, and the
``summarize`` / ``serve`` command line in process on the CPU (micro widths, a
checkpoint written by the test): a malformed line answered and the loop
going on, a stop signal draining, every line answered, the combinations
of flags the config's rules refuse, and ``top`` answering without a card."""

import io
import json
import os
import types

import numpy as np
import pytest
import torch

from torch_parity import MICRO, one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SNIPPETS = [
    "def add(a, b):\n    return a + b\n",
    "def parseHTTPResponse(raw_bytes, max_len=10):\n    head, _, body = raw_bytes.partition(b'\\r\\n')\n"
    "    if len(body) > max_len:\n        raise ValueError('too long')\n    return head.decode(), body\n",
    "def walk(tree):\n    for child in tree.children:\n        yield from walk(child)\n    yield tree\n",
    "class Stack:\n    def push(self, item):\n        self.items.append(item)\n",
    "def f(xs):\n    return sorted({x: x ** 2 for x in xs if x % 2}, key=lambda k: -k)\n",
    "def g(n):\n    total = 0\n    while n:\n        total, n = total + n % 10, n // 10\n"
    "    try:\n        return int(total)\n    except (TypeError, ValueError) as err:\n        return str(err)\n",
    "import os\nimport sys\n",
    "async def fetch(session, url):\n    async with session.get(url) as resp:\n"
    "        return await resp.text()\n",
]


def _vocab(cls, words):
    v = cls(False)
    for w in words:
        v.add(w)
    return v


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_extract_and_sample_from_source_bitwise_jax(i):
    from csat_tpu.configs import get_config as jget
    from csat_tpu.data.extract import source_to_ast_json as jextract
    from csat_tpu.data.vocab import Vocab as JVocab
    from csat_tpu.serve.ingest import sample_from_source as jsample
    from csat_tpu_torch.configs import get_config as tget
    from csat_tpu_torch.data.extract import source_to_ast_json as textract
    from csat_tpu_torch.data.vocab import Vocab as TVocab
    from csat_tpu_torch.serve.ingest import sample_from_source as tsample

    src = SNIPPETS[i]
    nodes = textract(src)
    assert nodes == jextract(src)
    words = sorted({":".join(n["label"].split(":")[1:-1]) for n in nodes})[::2]
    for name, over in (("python", {}), ("python_triplet", dict(max_src_len=12))):
        a = tsample(src, tget(name, **over), _vocab(TVocab, words),
                    _vocab(TVocab, ["Module", "arguments"]))
        b = jsample(src, jget(name, **over), _vocab(JVocab, words),
                    _vocab(JVocab, ["Module", "arguments"]))
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


def test_extract_errors_equal_jax():
    from csat_tpu.data.extract import source_to_ast_json as jextract
    from csat_tpu_torch.data.extract import source_to_ast_json as textract
    from csat_tpu_torch.data.extract import split_identifier_into_parts

    for bad in ("def f(:\n    pass\n", "x = (\n"):
        with pytest.raises(SyntaxError):
            jextract(bad)
        with pytest.raises(SyntaxError):
            textract(bad)
    with pytest.raises(RuntimeError) as t_err:
        textract("class A {}", "java")
    with pytest.raises(RuntimeError) as j_err:
        jextract("class A {}", "java")
    assert str(t_err.value) == str(j_err.value)
    assert split_identifier_into_parts("parseHTTPResponse_v2") == [
        "parse", "http", "response", "v", "2"]


PARSE_CASES = [
    ('{"id": "a", "code": "x", "max_new_tokens": 3}\n', 0),
    ("def f(): pass\n", 0),
    ('"just a string"\n', 5),
    ("42\n", 0),
    ("[1, 2]\n", 3),
    ('{"id": 7}\n', 0),
    ('{"code": 5}\n', 2),
    ('{"code": "x", "max_new_tokens": "lots"}\n', 0),
    ('{"code": "x", "max_new_tokens": 0}\n', 0),
    ('{"code": "x", "priority": 2}\n', 0),
    ('{"code": "x", "priority": "hi"}\n', 0),
    ('{"code": "x", "priority": -1}\n', 0),
    ('{"id": null, "code": "y"}\n', 9),
    ("not json at all {\n", 1),
]


@pytest.mark.parametrize("line,n_anon", PARSE_CASES)
def test_parse_request_equals_jax(line, n_anon):
    from csat_tpu.serve.cli import _parse_request as jparse
    from csat_tpu_torch.serve.cli import _parse_request as tparse

    assert tparse(line, n_anon) == jparse(line, n_anon)


def test_stdin_reader_handles_bursts():
    from csat_tpu_torch.serve.cli import _StdinLines

    r, w = os.pipe()
    try:
        os.write(w, b'{"id":1,"code":"x"}\n42\nhello\n')
        reader = _StdinLines(types.SimpleNamespace(fileno=lambda: r))
        assert len(reader.read_lines(0.1)) == 3 and not reader.eof
        os.write(w, b"partial")
        assert reader.read_lines(0.05) == []
        os.write(w, b" done\n")
        assert reader.read_lines(0.1) == ["partial done\n"]
    finally:
        os.close(w)
    assert reader.read_lines(0.1) == [] and reader.eof
    os.close(r)


# ---------------------------------------------------------------------------
# the command line in process
# ---------------------------------------------------------------------------

def _set_flags():
    return [x for k, v in MICRO.items() for x in ("--set", f"{k}={v!r}")]


@pytest.fixture(scope="module")
def served_ckpt(tmp_path_factory):
    """A corpus's vocabularies and a micro model's parameters saved where the
    trainer saves them."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.data.vocab import load_vocab
    from csat_tpu_torch.train.checkpoint import save_params
    from csat_tpu_torch.train.state import make_model

    root = tmp_path_factory.mktemp("cli")
    data = make_corpus(str(root / "corpus"), 24, 4, 4, seed=3)
    src, tgt = load_vocab(data)
    cfg = get_config("python", **MICRO, data_dir=data)
    model = make_model(cfg, src.size(), tgt.size(), device="cpu", seed=5)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    save_params(str(ckpt), dict(model.named_parameters()))
    return data, str(ckpt), str(root)


def _base(served_ckpt):
    data, ckpt, root = served_ckpt
    return ["--config", "python", "--data_dir", data, "--checkpoint_dir", ckpt,
            "--device", "cpu", "--postmortem_dir", os.path.join(root, "pm"), *_set_flags()]


def test_summarize_in_process_equals_engine(served_ckpt, tmp_path, capsys):
    from csat_tpu_torch.serve import cli

    files = []
    for i, src in enumerate(SNIPPETS[:3] + ["def broken(:\n"]):
        files.append(str(tmp_path / f"s{i}.py"))
        with open(files[-1], "w") as f:
            f.write(src)
    cli.main(["summarize", *_base(served_ckpt), "--max_new_tokens", "6",
              "--traces_file", str(tmp_path / "t.jsonl"), *files])
    out, err = capsys.readouterr()
    recs = [json.loads(x) for x in out.splitlines()]
    assert [r["source"] for r in recs] == files
    assert all(r["status"] == "OK" and r["n_tokens"] >= 1 for r in recs[:3])
    assert "SyntaxError" in recs[3]["error"] and "status" not in recs[3]
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["retired"] == 3 and stats["submitted"] == 3
    assert os.path.exists(tmp_path / "t.jsonl")

    # the same snippets through ServeEngine in this process: the same words
    args = cli._parser().parse_args(_base(served_ckpt) + ["--max_new_tokens", "6"])
    engine, cfg, src_vocab, trip_vocab = cli.build_engine(args)
    ids = [cli._ingest(engine, cfg, src_vocab, trip_vocab, s, 6) for s in SNIPPETS[:3]]
    engine.drain()
    assert [" ".join(engine.words(engine.poll(i))) for i in ids] == [
        r["summary"] for r in recs[:3]]
    engine.close()


class _StopAfter:
    """A stop flag that rises at its ``n``-th look — a signal arriving while
    requests are in flight, without a real signal in the test process."""

    def __init__(self, n):
        self.n, self.looks = n, 0

    @property
    def triggered(self):
        self.looks += 1
        return self.looks >= self.n

    def installed(self):
        import contextlib

        return contextlib.nullcontext(self)


def test_serve_loop_in_process_malformed_lines_and_stop(served_ckpt, capsys):
    from csat_tpu_torch.serve import cli

    lines = [json.dumps({"id": "a", "code": SNIPPETS[0]}), "42", json.dumps({"id": 7}),
             json.dumps({"id": "syn", "code": "def f(:\n"}),
             json.dumps({"id": "b", "code": SNIPPETS[2], "max_new_tokens": 3}),
             json.dumps({"code": SNIPPETS[3], "priority": 1}),
             json.dumps({"id": "c", "code": SNIPPETS[4], "priority": "hi"}),
             json.dumps({"id": "d", "code": SNIPPETS[5]})]
    r, w = os.pipe()
    os.write(w, ("\n".join(lines) + "\n").encode())  # one burst; stdin stays open
    try:
        args = cli._parser().parse_args(_base(served_ckpt) + ["--drain_deadline_s", "60"])
        cli._serve(args, stdin=types.SimpleNamespace(fileno=lambda: r), stop=_StopAfter(3))
    finally:
        os.close(w)
        os.close(r)
    out, err = capsys.readouterr()
    recs = {str(x["id"]): x for x in map(json.loads, out.splitlines())}
    assert set(recs) == {"a", "0", "7", "syn", "b", "1", "c", "d"}  # every line answered
    assert all(x["status"] == "OK" for k, x in recs.items() if k in ("a", "b", "1", "d"))
    assert recs["b"]["n_tokens"] <= 3
    assert "JSON object" in recs["0"]["error"] and "code" in recs["7"]["error"]
    assert "SyntaxError" in recs["syn"]["error"] and "priority" in recs["c"]["error"]
    assert all(x["status"] == "FAILED" for k, x in recs.items() if k in ("0", "7", "syn", "c"))
    assert "# serve: shutdown signal — draining" in err
    assert json.loads(err.strip().splitlines()[-1])["retired"] == 4


def test_serve_loop_slo_alert_in_heartbeat_and_metrics(served_ckpt, tmp_path, capsys):
    """``serve --slo``: a burst into a queue of 1 is mostly refused, the
    availability alert fires (its objective in the heartbeat), its gauges
    land in the metrics file, and ``top`` renders them."""
    import threading

    from csat_tpu_torch.serve import cli

    metrics = str(tmp_path / "m.jsonl")
    lines = [json.dumps({"id": i, "code": SNIPPETS[i % len(SNIPPETS)]}) for i in range(6)]
    r, w = os.pipe()
    # after the loop's first idle round, so the SLO engine has its baseline;
    # the stop flag counts its looks from the write on
    written = threading.Event()
    timer = threading.Timer(0.5, lambda: (os.write(w, ("\n".join(lines) + "\n").encode()),
                                          written.set()))
    timer.start()
    try:
        args = cli._parser().parse_args(_base(served_ckpt) + [
            "--slo", "--max_queue", "1", "--queue_policy", "reject", "--heartbeat_s", "1e-9",
            "--metrics_file", metrics, "--set", "slo_availability=0.9", "--set",
            "slo_burn_fast=2.0", "--set", "slo_burn_slow=1.0"])
        cli._serve(args, stdin=types.SimpleNamespace(fileno=lambda: r),
                   stop=_StopAfterEvent(12, written))
    finally:
        timer.join()
        os.close(w)
        os.close(r)
    out, err = capsys.readouterr()
    statuses = sorted(json.loads(x)["status"] for x in out.splitlines())
    assert statuses.count("REJECTED") >= 4 and "OK" in statuses
    beats = [json.loads(x.split("# heartbeat ", 1)[1]) for x in err.splitlines()
             if x.startswith("# heartbeat ")]
    assert any(b.get("slo_alerts") == ["availability"] for b in beats)
    with open(metrics) as f:
        snap = json.loads(f.read().splitlines()[-1])
    assert "slo_alert_availability" in snap and snap["slo_burn_fast_availability"] > 0
    with pytest.raises(SystemExit) as info:
        cli.main(["top", "--metrics", metrics, "--once"])
    assert info.value.code == 0 and "== slo burn ==" in capsys.readouterr().out


class _StopAfterEvent(_StopAfter):
    """A stop flag counting its looks only once ``event`` is set."""

    def __init__(self, n, event):
        super().__init__(n)
        self.event = event

    @property
    def triggered(self):
        return self.event.is_set() and _StopAfter.triggered.fget(self)


@pytest.mark.parametrize("flag", [["--autoscale", "--min_replicas", "3", "--max_replicas", "2"],
                                  ["--tiering", "--prefix_cache", "0"],
                                  ["--tiering", "--kv_layout", "rect"], ["--mesh", "2x2"],
                                  ["--kv_layout", "rect", "--mesh", "2"]])
def test_later_slice_flags_refused(served_ckpt, flag):
    """A combination of flags the config's rules refuse (JAX's asserts:
    tiering without a prefix cache or outside the paged layout, a mesh with a
    data axis above 1 or over the rect layout, an autoscale ceiling below its
    floor) exits with its one line; every flag of the JAX command line is
    ported."""
    from csat_tpu_torch.serve import cli

    with pytest.raises(SystemExit) as info:
        cli.main(["serve", *_base(served_ckpt), *flag])
    msg = str(info.value)
    if flag[0] == "--autoscale":
        assert msg == "python: 2"  # JAX's assert: serve_max_replicas >= serve_min_replicas
    elif flag[0] == "--mesh":
        assert "serve_mesh_shape (2, 2)" in msg and "leading (data) axis must be 1" in msg
    elif flag[0] == "--tiering":
        want = "a prefix cache" if "--prefix_cache" in flag else "serve_kv_layout='paged'"
        assert msg.startswith("python: serve_tiering requires") and want in msg
    else:
        assert flag[0] == "--kv_layout"
        assert "serve_mesh_shape spanning >1 device requires serve_kv_layout='paged'" in msg


def test_tiered_summarize_equals_untiered(served_ckpt, tmp_path, capsys):
    """``summarize --tiering`` on a pool too small for the snippets' chains
    (spills under pressure) prints what the untiered command prints."""
    from csat_tpu_torch.serve import cli

    files = []
    for i, src in enumerate(SNIPPETS[:3] * 2):
        files.append(str(tmp_path / f"s{i}.py"))
        with open(files[-1], "w") as f:
            f.write(src)
    outs = []
    for extra in ([], ["--tiering", "--tier_host_pages", "2",
                       "--tier_dir", str(tmp_path / "tiers")]):
        cli.main(["summarize", *_base(served_ckpt), "--max_new_tokens", "5", "--serve_slots",
                  "2", *extra, *files])
        out, err = capsys.readouterr()
        outs.append(out)
        stats = json.loads(err.strip().splitlines()[-1])
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == len(files)
    assert all(json.loads(x)["status"] == "OK" for x in outs[1].splitlines())
    assert stats["retired"] == len(files)
    assert stats["tier_spills"] > 0 and stats["tier_restores"] > 0


def test_cli_raises_without_cuda_unless_cpu_is_asked(served_ckpt, monkeypatch, tmp_path, capsys):
    from csat_tpu_torch import cli

    base = [x for x in _base(served_ckpt) if x not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["summarize", *base, os.devnull])
    # top reads files only: it answers without a card
    metrics = tmp_path / "m.jsonl"
    metrics.write_text(json.dumps({"t": 0.0, "serve_requests_ok_total": 3}) + "\n")
    with pytest.raises(SystemExit) as info:
        cli.main(["top", "--metrics", str(metrics), "--once"])
    assert info.value.code == 0 and "ok 3" in capsys.readouterr().out
    monkeypatch.setattr("sys.stdin", io.StringIO("def f(x):\n    return x\n"))
    cli.main(["summarize", *base, "--device", "cpu"])


def test_summarize_over_a_fleet_equals_one_engine(served_ckpt, tmp_path, capsys):
    """``--replicas 2`` (and ``--autoscale`` alone, a fleet of one) serve the
    snippets through a ``Fleet``: the same lines as one engine, and the stats
    line is the fleet's summary."""
    from csat_tpu_torch.serve import cli

    files = []
    for i, src in enumerate(SNIPPETS[:3] * 2):
        files.append(str(tmp_path / f"s{i}.py"))
        with open(files[-1], "w") as f:
            f.write(src)
    outs, stats = [], []
    for extra in ([], ["--replicas", "2"], ["--autoscale", "--max_replicas", "2"]):
        cli.main(["summarize", *_base(served_ckpt), "--max_new_tokens", "5", "--serve_slots",
                  "2", *extra, *files])
        out, err = capsys.readouterr()
        outs.append(out)
        stats.append(json.loads(err.strip().splitlines()[-1]))
    assert outs[0] == outs[1] == outs[2] and len(outs[0].splitlines()) == len(files)
    assert all(json.loads(x)["status"] == "OK" for x in outs[1].splitlines())
    assert "replicas" not in stats[0]
    assert (stats[1]["replicas"], stats[2]["replicas"]) == (2, 1)
    assert stats[1]["retired"] == len(files) and len(stats[1]["per_replica"]) == 2
