"""``summarize`` / ``serve`` — code in, summaries out.

The JAX package's ``serve/cli.py`` for the port::

    python -m csat_tpu_torch.cli summarize --config python --data_dir DIR \\
        --checkpoint_dir OUT snippet1.py snippet2.py
    cat requests.jsonl | python -m csat_tpu_torch.cli serve --config python \\
        --data_dir DIR --checkpoint_dir OUT

Both build the same stack: named config (``--set field=value`` overrides any
field) + the vocabularies under ``--data_dir`` + the parameters the port's
trainer saved (``best_model.pt`` under ``--checkpoint_dir``, default the
run's output dir) → :class:`~csat_tpu_torch.serve.engine.ServeEngine`; raw
snippets go through ``serve/ingest.py:sample_from_source`` per request.  It
runs on the card; ``--device cpu`` runs the plain PyTorch path on the CPU,
and without a GPU and without ``--device cpu`` it raises.

* ``summarize`` — read snippets (files given as arguments, or
  ``--sep``-delimited blocks on stdin), submit them all, drain, print one
  JSON line per snippet, then the engine's stats line on stderr.
* ``serve`` — a JSONL loop: each stdin line is a request ``{"id": ...,
  "code": ..., "max_new_tokens"?: ..., "priority"?: ...}`` (or a bare
  string); responses stream out as JSON lines as they finish.  Every
  response carries a ``status`` (``OK | FAILED | TIMEOUT | REJECTED |
  SHED``); a malformed line gets an error record and the loop goes on.
  EOF drains and exits; SIGTERM / SIGINT stops intake and drains, shedding
  whatever is left after ``--drain_deadline_s``; exit 0 either way.

``--mesh H`` or ``--mesh 1xH`` (the JAX flag's parsing) serves with ONE
engine across ``H`` head shards, one visible card each
(``cfg.serve_mesh_shape``; a data axis above 1 is refused, as JAX refuses
it).  The serving engine's storage takes the JAX flags: ``--kv_layout rect``
(the per-slot rectangles, ``serve/slots.py``), ``--tiering`` with
``--tier_host_pages`` / ``--tier_disk_pages`` / ``--tier_dir`` (KV tiers
below the page pool, ``serve/tiering.py``) and ``--warmstart`` (the kernel
library store, ``serve/warmstart.py``); a combination the config's rules
refuse (tiering without a prefix cache, rect under a mesh) exits with its
one line.  The JAX command line's replica fleet (``--replicas`` > 1),
autoscale, SLOs, the network front door (``--net``) and ``top`` are not part
of the port yet: each is refused with a one-line message, never silently
ignored.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import sys
from typing import List, Optional

__all__ = ["main", "build_engine"]

# flag → the later slice it waits for; refused while set
_LATER = {
    "replicas": "the replica fleet and router",
    "autoscale": "the fleet's autoscale",
    "min_replicas": "the fleet's autoscale",
    "max_replicas": "the fleet's autoscale",
    "slo": "obs/slo.py",
    "net": "the network front door",
}


def _parser() -> argparse.ArgumentParser:
    # the subcommand is stripped by main() before parsing, as in the JAX CLI
    p = argparse.ArgumentParser(prog="csat_tpu_torch serve|summarize", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="named variant, e.g. python")
    p.add_argument("--data_dir", default="", help="override the config's data_dir (vocabs)")
    p.add_argument("--checkpoint_dir", default="",
                   help="directory of best_model.pt (default: the config's output dir)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; never falls back on its own")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="FIELD=VALUE", help="override a config field")
    p.add_argument("--serve_slots", type=int, default=0,
                   help="decode-slot pool size (default: config serve_slots)")
    p.add_argument("--page_size", type=int, default=0,
                   help="tokens per KV page (default: config serve_page_size)")
    p.add_argument("--num_pages", type=int, default=-1,
                   help="page-pool size incl. the null page; 0 = every slot's worst case "
                        "(default: config serve_num_pages)")
    p.add_argument("--kv_page_dtype", default="",
                   help="float32 | bfloat16 | int8 KV page storage "
                        "(default: config serve_kv_page_dtype)")
    p.add_argument("--prefix_cache", type=int, default=-1,
                   help="cross-request prefix-cache entries; 0 = off "
                        "(default: config serve_prefix_cache)")
    p.add_argument("--max_new_tokens", type=int, default=0,
                   help="per-request decode budget (0 = max_tgt_len - 1)")
    p.add_argument("--max_queue", type=int, default=-1,
                   help="admission-control queue bound (0 = unbounded; "
                        "default: config serve_max_queue)")
    p.add_argument("--queue_policy", default="",
                   help="reject | shed_oldest (default: config serve_queue_policy)")
    p.add_argument("--deadline_s", type=float, default=-1.0,
                   help="default per-request deadline in seconds (0 = none; "
                        "default: config serve_deadline_s)")
    p.add_argument("--drain_deadline_s", type=float, default=30.0,
                   help="serve: on SIGTERM/SIGINT, drain in-flight work for at most this "
                        "long before shedding the rest")
    p.add_argument("--metrics_file", default="",
                   help="append periodic JSONL metrics snapshots here "
                        "(cadence --metrics_every_s)")
    p.add_argument("--metrics_every_s", type=float, default=0.0,
                   help="metrics-snapshot cadence in seconds "
                        "(default: config obs_metrics_every_s)")
    p.add_argument("--heartbeat_s", type=float, default=0.0,
                   help="serve: a one-line JSON heartbeat on stderr every N seconds (0 = off)")
    p.add_argument("--trace_file", default="",
                   help="on exit, export the engine's phase spans as Chrome trace JSON here")
    p.add_argument("--traces_file", default="",
                   help="on exit, dump the slowest and still-active request traces as "
                        "JSONL here")
    p.add_argument("--postmortem_dir", default="",
                   help="where fault post-mortem dumps land (default: config "
                        "obs_postmortem_dir)")
    p.add_argument("--sep", default="\x00", help="summarize stdin snippet separator (NUL)")
    # the JAX command line's flags of parts the port does not carry yet
    p.add_argument("--replicas", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--autoscale", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--min_replicas", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--max_replicas", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--warmstart", action="store_true",
                   help="warm-start store (serve/warmstart.py): keep the built kernel "
                        "libraries, digest-verified, under the cache root so a new "
                        "engine loads them instead of running nvcc")
    p.add_argument("--tiering", action="store_true",
                   help="tiered KV page store (serve/tiering.py): spill cold prefix-cache "
                        "chains to host RAM / a digest-verified disk tier instead of "
                        "destroying them; identical later admissions restore instead of "
                        "re-prefilling (requires --kv_layout paged and a prefix cache)")
    p.add_argument("--tier_host_pages", type=int, default=0,
                   help="host-tier budget in KV pages; 0 = unbounded (overflow demotes LRU "
                        "snapshots to disk)")
    p.add_argument("--tier_disk_pages", type=int, default=0,
                   help="disk-tier budget in KV pages; 0 = unbounded (overflow deletes LRU "
                        "snapshot files)")
    p.add_argument("--tier_dir", default="",
                   help="disk-tier directory (default: <output_dir>/kv_tiers)")
    p.add_argument("--mesh", default="",
                   help="serve-mesh shape for ONE engine across cards: 'H' or 'DxH' chip "
                        "counts, e.g. --mesh 2 or --mesh 1x2 — KV pages and paged attention "
                        "shard across H on the head axis, everything else stays on the "
                        "first card; requires --kv_layout paged (default: config serve_mesh_shape, "
                        "i.e. solo)")
    p.add_argument("--kv_layout", default="",
                   help="paged | rect KV-cache layout (default: config serve_kv_layout)")
    p.add_argument("--slo", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--net", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("files", nargs="*", help="summarize: files holding one snippet each")
    return p


def _refuse_later(args) -> None:
    """A flag of a part the port does not carry is an error, not a no-op."""
    for flag, slice_ in _LATER.items():
        value = getattr(args, flag)
        if flag == "replicas" and value <= 1:
            continue
        if flag == "max_replicas" and value < 0:
            continue
        if value:
            raise SystemExit(f"csat_tpu_torch serve: --{flag} is not part of the port yet "
                             f"({slice_} is a later slice)")


def build_engine(args):
    """Config / vocabs / params / engine bring-up shared by both subcommands;
    returns ``(engine, cfg, src_vocab, trip_vocab)``."""
    _refuse_later(args)
    from csat_tpu_torch.configs import cli_config
    from csat_tpu_torch.data.vocab import Vocab, load_vocab
    from csat_tpu_torch.serve.engine import ServeEngine
    from csat_tpu_torch.train.checkpoint import restore_params
    from csat_tpu_torch.train.state import make_model
    from csat_tpu_torch.utils import resolve_device

    overrides = {}
    for item in args.overrides:
        field, _, value = item.partition("=")
        overrides[field] = ast.literal_eval(value)
    for flag, field, unset in (
            ("data_dir", "data_dir", ""), ("serve_slots", "serve_slots", 0),
            ("page_size", "serve_page_size", 0), ("num_pages", "serve_num_pages", -1),
            ("kv_page_dtype", "serve_kv_page_dtype", ""),
            ("prefix_cache", "serve_prefix_cache", -1), ("max_queue", "serve_max_queue", -1),
            ("kv_layout", "serve_kv_layout", ""), ("warmstart", "serve_warmstart", False),
            ("tiering", "serve_tiering", False), ("tier_host_pages", "serve_tier_host_pages", 0),
            ("tier_disk_pages", "serve_tier_disk_pages", 0), ("tier_dir", "serve_tier_dir", ""),
            ("queue_policy", "serve_queue_policy", ""), ("deadline_s", "serve_deadline_s", -1.0),
            ("metrics_file", "obs_metrics_file", ""),
            ("postmortem_dir", "obs_postmortem_dir", "")):
        value = getattr(args, flag)
        if value != unset:
            overrides[field] = value
    if args.metrics_every_s > 0:
        overrides["obs_metrics_every_s"] = args.metrics_every_s
    if args.mesh:
        try:
            overrides["serve_mesh_shape"] = tuple(int(s) for s in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh wants 'H' or 'DxH' chip counts, got {args.mesh!r}")
    cfg = cli_config(args.config, overrides)
    device = resolve_device(args.device)

    src_vocab, tgt_vocab = load_vocab(cfg.data_dir)
    trip_path = os.path.join(cfg.data_dir, f"node_triplet_dictionary_{cfg.lang}.pt")
    trip_vocab = (Vocab(need_bos=False, file_path=trip_path).load()
                  if os.path.exists(trip_path) else None)
    model = make_model(cfg, src_vocab.size(), tgt_vocab.size(),
                       trip_vocab.size() if trip_vocab else 0, device=device)
    ckpt = args.checkpoint_dir or os.path.join(cfg.output_dir, cfg.project_name, cfg.task_name)
    model.load_state_dict(restore_params(ckpt), strict=True)
    model.eval()
    engine = ServeEngine(model, cfg, device=device, tgt_vocab=tgt_vocab,
                         log=lambda m: print(m, file=sys.stderr))
    return engine, cfg, src_vocab, trip_vocab


def _telemetry(engine, cfg, args):
    """An optional periodic JSONL metrics writer, and a finalizer that
    flushes the last snapshot and writes the trace exports."""
    from csat_tpu_torch.obs import MetricsFile, write_chrome_trace

    writer = None
    if cfg.obs_metrics_file:
        # looked up per write: reset_stats swaps the stats object
        writer = MetricsFile(cfg.obs_metrics_file, lambda: engine.stats.registry,
                             every_s=cfg.obs_metrics_every_s)

    def extra():
        return {"queue_depth": engine.queue_depth, "occupancy": engine.occupancy}

    def finalize() -> None:
        if writer is not None:
            writer.maybe_write(extra=extra(), force=True)
        if args.trace_file:
            write_chrome_trace(args.trace_file, engine.obs)
        if args.traces_file:
            engine.tracer.dump(args.traces_file)

    return writer, extra, finalize


def _ingest(engine, cfg, src_vocab, trip_vocab, code: str, max_new_tokens: int,
            priority: int = 0) -> int:
    from csat_tpu_torch.serve.ingest import sample_from_source

    sample = sample_from_source(code, cfg, src_vocab, trip_vocab)
    return engine.submit(sample, max_new_tokens=max_new_tokens, priority=priority)


def _summarize(args) -> None:
    from csat_tpu_torch.resilience.retry import DataErrorBudgetExceeded

    engine, cfg, src_vocab, trip_vocab = build_engine(args)
    _, _, finalize = _telemetry(engine, cfg, args)
    if args.files:
        snippets = []
        for name in args.files:
            with open(name, encoding="utf-8") as f:
                snippets.append(f.read())
        names: List[str] = list(args.files)
    else:
        snippets = [s for s in sys.stdin.read().split(args.sep) if s.strip()]
        names = [f"stdin:{i}" for i in range(len(snippets))]
    ids, errors = {}, {}
    with contextlib.ExitStack() as teardown:
        teardown.callback(finalize)
        teardown.callback(engine.close)
        for name, code in zip(names, snippets):
            try:
                ids[name] = _ingest(engine, cfg, src_vocab, trip_vocab, code,
                                    args.max_new_tokens)
            except DataErrorBudgetExceeded:
                raise  # a mostly-poison input is an upstream corruption event
            except (SyntaxError, ValueError, RecursionError, RuntimeError) as e:
                errors[name] = f"{type(e).__name__}: {e}"
        engine.drain()
        for name in names:
            if name in errors:
                print(json.dumps({"source": name, "error": errors[name]}))
                continue
            req = engine.poll(ids[name])
            rec = {"source": name, "status": req.status}
            if not req.ok:
                rec["error"] = req.error or req.status
            if req.ok or req.n_tokens:
                rec.update(summary=" ".join(engine.words(req)), n_tokens=req.n_tokens)
            print(json.dumps(rec))
    print(json.dumps(engine.stats.summary(n_chips=1)), file=sys.stderr)


def _parse_request(line: str, n_anon: int):
    """One stdin line → ``(ext_id, code, max_new_tokens_override, priority,
    n_anon, error)``.  Never raises: a malformed line (a non-object JSON
    value, a missing or non-string ``code``, a non-integer budget or
    priority, a negative priority) comes back as ``error`` so the loop emits
    one error record and goes on; a line that is not JSON is the code
    itself."""
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        rec = {"code": line.rstrip("\n")}
    if isinstance(rec, str):
        rec = {"code": rec}
    if not isinstance(rec, dict):
        return n_anon, None, None, 0, n_anon + 1, (
            f"request line must be a JSON object or a bare string, got {type(rec).__name__}")
    ext_id = rec.get("id")
    if ext_id is None:
        ext_id = n_anon
        n_anon += 1
    code = rec.get("code")
    if not isinstance(code, str):
        return ext_id, None, None, 0, n_anon, "missing or non-string 'code' field"
    # None = absent (the server's default); an explicit 0 = the full budget
    max_new = rec.get("max_new_tokens")
    if max_new is not None:
        try:
            max_new = int(max_new)
        except (TypeError, ValueError):
            return ext_id, None, None, 0, n_anon, "non-integer 'max_new_tokens'"
    priority = rec.get("priority", 0)
    try:
        priority = int(priority)
    except (TypeError, ValueError):
        return ext_id, None, None, 0, n_anon, "non-integer 'priority'"
    if priority < 0:
        return ext_id, None, None, 0, n_anon, "negative 'priority'"
    return ext_id, code, max_new, priority, n_anon, None


class _StdinLines:
    """``select()``-safe line reader: one ``os.read`` per readable select,
    then every complete line in its own buffer at once — a burst of lines
    never sits in Python's io buffer where ``select()`` cannot see it."""

    def __init__(self, f):
        self._fd = f.fileno()
        self._buf = bytearray()
        self.eof = False

    def read_lines(self, timeout: float) -> List[str]:
        """Every complete line available within ``timeout`` (possibly none);
        sets :attr:`eof` once the pipe closes."""
        import select

        if not self.eof:
            readable, _, _ = select.select([self._fd], [], [], timeout)
            if readable:
                chunk = os.read(self._fd, 1 << 16)
                if chunk == b"":
                    self.eof = True
                else:
                    self._buf += chunk
        lines = []
        while True:
            i = self._buf.find(b"\n")
            if i < 0:
                break
            lines.append(self._buf[: i + 1].decode("utf-8", "replace"))
            del self._buf[: i + 1]
        if self.eof and self._buf:  # an unterminated final line
            lines.append(self._buf.decode("utf-8", "replace"))
            self._buf.clear()
        return lines


def _serve(args, stdin=None, stop=None) -> None:
    """The JSONL loop over ``stdin`` (default ``sys.stdin``); ``stop`` is the
    :class:`~csat_tpu_torch.resilience.preemption.PreemptionHandler` whose
    flag starts the graceful drain (default: a fresh one on SIGTERM /
    SIGINT)."""
    from csat_tpu_torch.resilience.preemption import PreemptionHandler
    from csat_tpu_torch.resilience.retry import DataErrorBudgetExceeded

    engine, cfg, src_vocab, trip_vocab = build_engine(args)
    writer, extra, finalize = _telemetry(engine, cfg, args)
    hb_every = max(args.heartbeat_s, 0.0)
    last_hb = engine.clock()
    hb_keys = ("submitted", "retired", "failed", "timeouts", "rejected", "shed",
               "gen_tokens", "gen_tokens_per_sec", "compiles")

    def flush_finished(pending: dict) -> None:
        for rid in [r for r in pending if engine.poll(r) is not None]:
            req = engine.pop_result(rid)
            rec = {"id": pending.pop(rid), "status": req.status}
            if req.ok or req.n_tokens:
                # in-flight TIMEOUT / SHED deliver the tokens decoded so far
                rec.update(summary=" ".join(engine.words(req)), n_tokens=req.n_tokens)
            if req.ok:
                rec["latency_s"] = round(req.done_t - req.submit_t, 4)
            else:
                rec["error"] = req.error or req.status
            if req.status in ("REJECTED", "SHED"):
                rec["priority"] = req.priority
                if req.retry_after_s is not None:
                    rec["retry_after_s"] = req.retry_after_s
            print(json.dumps(rec), flush=True)

    pending: dict = {}
    n_anon = 0  # default ids, never reused across the run
    lines = _StdinLines(stdin if stdin is not None else sys.stdin)
    eof = False
    drain_deadline = None  # armed by the stop flag
    stop = stop if stop is not None else PreemptionHandler()
    # the teardown stack flushes the post-mortems (close) and the last
    # snapshot and trace exports (finalize) even when the loop dies
    with contextlib.ExitStack() as teardown:
        teardown.callback(finalize)
        teardown.callback(engine.close)
        teardown.enter_context(stop.installed())
        while not eof or pending or engine.occupancy or engine.queue_depth:
            if stop.triggered and drain_deadline is None:
                # graceful drain: stop intake, finish what is in flight,
                # shed whatever remains at the deadline
                eof = True
                drain_deadline = engine.clock() + max(args.drain_deadline_s, 0.0)
                print(f"# serve: shutdown signal — draining {len(pending)} request(s) for "
                      f"up to {args.drain_deadline_s:.1f}s", file=sys.stderr, flush=True)
            if drain_deadline is not None and engine.clock() > drain_deadline:
                engine.shed_all("graceful drain deadline expired")
            busy = bool(pending or engine.occupancy or engine.queue_depth)
            if not eof:
                for line in lines.read_lines(0.0 if busy else 0.2):
                    if not line.strip():
                        continue
                    ext_id, code, max_new, pr, n_anon, err = _parse_request(line, n_anon)
                    if err is not None:
                        print(json.dumps({"id": ext_id, "status": "FAILED", "error": err}),
                              flush=True)
                        continue
                    try:
                        rid = _ingest(engine, cfg, src_vocab, trip_vocab, code,
                                      max_new if max_new is not None else args.max_new_tokens,
                                      priority=pr)
                        pending[rid] = ext_id
                    except DataErrorBudgetExceeded:
                        raise  # the poison budget is spent: fail loud
                    except (SyntaxError, ValueError, RecursionError, RuntimeError) as e:
                        print(json.dumps({"id": ext_id, "status": "FAILED",
                                          "error": f"{type(e).__name__}: {e}"}), flush=True)
                eof = eof or lines.eof
            if engine.occupancy or engine.queue_depth:
                engine.tick()
            flush_finished(pending)
            if writer is not None:
                writer.maybe_write(extra=extra())
            if hb_every and engine.clock() - last_hb >= hb_every:
                last_hb = engine.clock()
                s = engine.stats.summary(n_chips=1)
                hb = {k: s[k] for k in hb_keys}
                hb.update(queue_depth=engine.queue_depth, occupancy=engine.occupancy)
                print(f"# heartbeat {json.dumps(hb)}", file=sys.stderr)
    print(json.dumps(engine.stats.summary(n_chips=1)), file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "top":
        raise SystemExit("csat_tpu_torch top is not part of the port yet "
                         "(the live console comes with obs/slo.py, a later slice)")
    if not argv or argv[0] not in ("serve", "summarize"):
        raise SystemExit("usage: csat_tpu_torch.cli serve|summarize [options] [files ...]")
    command = argv.pop(0)
    args = _parser().parse_args(argv)
    if command == "summarize":
        _summarize(args)
    else:
        _serve(args)


if __name__ == "__main__":
    main()
