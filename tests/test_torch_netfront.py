"""The streaming network front door: the port's ``NetFront`` / ``NetClient``
against the JAX package's, the drills of ``tests/test_netfront.py`` run on
both stacks over real loopback sockets (port 0 everywhere).

The protocol and backpressure drills run against JAX's scripted
``FakeEngine`` (deterministic token schedules, no device work), once behind
each package's front door and client: every client stream's record, the
front's counters and event names, the client's counters and the stream
invariants must be equal, and JAX's own assertions hold on the port.  The
frame and brownout drills run live engines (``fleet_parity.stack``: the
micro config, JAX's weights converted, fake clocks): the raw frame lines the
client reads (ids, seq, tokens, ``done`` / ``status`` / ``n_tokens`` /
``browned`` / ``retry_after_s``) must be equal byte for byte.  Nothing here
reads a wall clock: JAX's wedged-reader latency ratio has a twin in counts
on an injected clock (the front's step never blocks on a full send buffer,
and the stalled connection costs only its own frames).  The command line:
the ``serve --net`` crash path drains and flushes, ``--net`` routes to the
front door, and a snippet that ingest refuses ends its stream FAILED."""

import json
import socket
import time
import types

import numpy as np
import pytest

import fleet_parity as fp
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PACKAGES = ("jax", "port")


def net(name):
    """The front door, client and invariant monitor of one package."""
    if name == "jax":
        from csat_tpu.resilience import InvariantMonitor
        from csat_tpu.serve.netclient import NetClient
        from csat_tpu.serve.netfront import NetFront, encode_frame
    else:
        from csat_tpu_torch.resilience import InvariantMonitor
        from csat_tpu_torch.serve.netclient import NetClient
        from csat_tpu_torch.serve.netfront import NetFront, encode_frame
    return types.SimpleNamespace(name=name, NetFront=NetFront, NetClient=NetClient,
                                 InvariantMonitor=InvariantMonitor, encode_frame=encode_frame)


@pytest.fixture(scope="module")
def cfgs():
    from torch_parity import configs

    jcfg, tcfg = configs()
    return {"jax": jcfg, "port": tcfg}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


class FakeEngine:
    """JAX's scripted engine of ``tests/test_netfront.py``: the wire
    ``sample`` is the token list the decode emits, ``per_tick`` a tick."""

    def __init__(self, cfg, per_tick: int = 2, reject_first: int = 0, retry_hint=None,
                 clock=None):
        self.cfg = cfg
        self.clock = clock if clock is not None else time.monotonic
        self.per_tick = per_tick
        self.reject_first = reject_first
        self.retry_hint = retry_hint
        self.ticks = 0
        self._next_id = 0
        self._live = {}
        self._results = {}

    def _terminal(self, status, tokens, priority, error=None):
        return types.SimpleNamespace(
            status=status, tokens=None if tokens is None else np.asarray(tokens, np.int32),
            priority=priority,
            retry_after_s=self.retry_hint if status in ("REJECTED", "SHED") else None,
            error=error, browned=False)

    def submit(self, sample, max_new_tokens=0, priority=0):
        sid = self._next_id
        self._next_id += 1
        if self.reject_first > 0:
            self.reject_first -= 1
            self._results[sid] = self._terminal("REJECTED", None, int(priority), "queue full")
            return sid
        self._live[sid] = {"tokens": [int(t) for t in sample], "emitted": 0,
                           "priority": int(priority)}
        return sid

    def tick(self):
        self.ticks += 1
        for sid, st in list(self._live.items()):
            st["emitted"] = min(len(st["tokens"]), st["emitted"] + self.per_tick)
            if st["emitted"] >= len(st["tokens"]):
                self._results[sid] = self._terminal("OK", st["tokens"], st["priority"])
                del self._live[sid]

    def partial_tokens(self):
        return {sid: np.asarray(st["tokens"][:st["emitted"]], np.int32)
                for sid, st in self._live.items()}

    def poll(self, sid):
        return self._results.get(sid)

    def pop_result(self, sid):
        return self._results.pop(sid)

    @property
    def queue_depth(self):
        return 0

    @property
    def occupancy(self):
        return len(self._live)


def _drive(front, client, max_iters=4000):
    """JAX's co-sim loop: step both sides until every stream and retry has
    resolved, then one last flush."""
    for _ in range(max_iters):
        front.step()
        client.step()
        if client.pending() == 0 and client.retry_pending() == 0 and not front._streams:
            break
    front.step()
    client.step()


def _streams(client):
    return {tag: (st.id, list(st.tokens), st.done, st.status, st.n_tokens, st.priority,
                  st.browned, st.retry_after_s, st.error, st.dups, st.gaps, st.lost, st.resumes)
            for tag, st in client.streams.items()}


def _record(pkg, cfg, front, client):
    """What the tests hold equal across the two stacks."""
    mon = pkg.InvariantMonitor(cfg)
    violations = [(v.invariant, v.detail) for v in mon.check_streams(front, client)]
    return dict(streams=_streams(client), counters=dict(front.counters),
                events=[e[1] for e in front.obs.events()],
                client=(client.reconnects, client.resumes_sent, list(client.backoffs),
                        client.hb_seen, client.errors, client.pending(),
                        client.retry_pending()),
                violations=violations, front_streams=front.streams(),
                status=front.stream_status())


def _both(cfgs, drill):
    """``drill(pkg, cfg)`` on each stack → {package: record}; the records
    must be equal."""
    got = {name: drill(net(name), cfgs[name]) for name in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------


class RecordingClient:
    """A ``NetClient`` whose every received line is kept, raw."""

    def __init__(self, client):
        self.lines = []
        inner = client._handle_line

        def handle(raw):
            if raw.strip():
                self.lines.append(raw.strip().decode())
            inner(raw)

        client._handle_line = handle


@pytest.fixture(scope="module")
def st():
    # three tenant tiers over one prefill bucket (JAX's net_cfg)
    return fp.stack(bucket_src_lens=(48,), serve_priority_classes=3)


def _live(st, name, over=None):
    pkg = fp.package(name)
    cfg = fp.cfg_of(pkg, st, **(over or {}))
    return fp.engine(pkg, st, cfg=cfg), cfg


def test_protocol_frame_lines_equal_jax(st):
    """Four submits (priorities 0–2, budget 4) against a live engine behind
    each front door: the frame lines the client reads are JAX's byte for
    byte — the ACK echoing tag and priority, the token frames, the terminal
    frame's status and ``n_tokens``; every stream OK, its assembly the
    front's authoritative tokens, the scrape counters moved, and the
    stream invariants clean."""
    samples = fp.samples(st.jcfg, 4, seed=11)
    got = {}
    for name in PACKAGES:
        eng, cfg = _live(st, name)
        pkg = net(name)
        front = pkg.NetFront(eng, make_sample=lambda m: samples[int(m["sample"])])
        client = pkg.NetClient(front.address)
        rec = RecordingClient(client)
        tags = [client.submit(i, priority=i % 3, max_new_tokens=4) for i in range(4)]
        _drive(front, client)
        authoritative = front.streams()
        for i, tag in enumerate(tags):
            s = client.streams[tag]
            assert s.done and s.status == "OK" and s.priority == i % 3
            assert s.tokens == authoritative[s.id] and len(s.tokens) == s.n_tokens > 0
        assert client.dup_total() == 0 and client.gap_total() == 0
        assert client.results() == authoritative
        assert eng.stats.net_frames > 0 and eng.stats.net_connections == 1
        got[name] = (rec.lines, _record(pkg, cfg, front, client),
                     eng.stats.net_frames, eng.stats.net_connections)
        front.close()
        client.close()
        assert eng.stats.net_connections == 0
        eng.close()
    assert got["port"] == got["jax"]
    lines = [json.loads(x) for x in got["port"][0]]
    assert lines[0]["seq"] == 0 and lines[0]["tokens"] == [] and "tag" in lines[0]
    assert sum(1 for x in lines if x.get("done")) == 4
    assert got["port"][1]["violations"] == []


def test_brownout_capped_streams_carry_the_marker_as_jax(st):
    """A tight queue: the brownout cap lands on low tiers and their terminal
    frames say ``browned``; refused streams carry ``retry_after_s`` ≥ the
    configured hint — the same frame lines as JAX's."""
    tight = dict(serve_max_queue=4, serve_queue_policy="shed_oldest",
                 serve_brownout_queue_frac=0.5, serve_brownout_max_new_tokens=2,
                 serve_retry_after_s=0.25)
    samples = fp.samples(st.jcfg, 12, seed=9)
    got = {}
    for name in PACKAGES:
        eng, cfg = _live(st, name, tight)
        pkg = net(name)
        front = pkg.NetFront(eng, make_sample=lambda m: samples[int(m["sample"])])
        client = pkg.NetClient(front.address)
        rec = RecordingClient(client)
        tags = [client.submit(i, priority=i % 3) for i in range(12)]
        _drive(front, client)
        sts = [client.streams[t] for t in tags]
        assert all(s.done for s in sts)
        browned = [s for s in sts if s.browned]
        assert browned and all(s.priority > 0 for s in browned)
        assert all(s.n_tokens == len(s.tokens) for s in browned)
        refused = [s for s in sts if s.status in ("REJECTED", "SHED")]
        assert refused and all(s.retry_after_s is not None and s.retry_after_s >= 0.25
                               for s in refused)
        got[name] = (rec.lines, _record(pkg, cfg, front, client))
        assert got[name][1]["violations"] == []
        front.close()
        client.close()
        eng.close()
    assert got["port"] == got["jax"]


def test_malformed_lines_survive_the_connection(cfgs):
    """Garbage on the wire costs an error line and a counter, never the
    connection: the stream submitted after it completes."""
    def drill(pkg, cfg):
        front = pkg.NetFront(FakeEngine(cfg), make_sample=lambda m: m["sample"])
        client = pkg.NetClient(front.address)
        client.step()
        client.send_garbage()
        client.send_garbage(b'{"what": 1}')
        tag = client.submit([7, 8, 9])
        _drive(front, client)
        rec = _record(pkg, cfg, front, client)
        front.close()
        client.close()
        return rec, tag

    rec, tag = _both(cfgs, drill)
    assert rec["counters"]["malformed"] == 2 and rec["counters"]["disconnects"] == 0
    assert rec["client"][4] >= 2 and rec["events"].count("net.malformed") == 2
    assert rec["streams"][tag][1:4] == ([7, 8, 9], True, "OK")


def test_wrong_typed_fields_never_fatal(cfgs):
    """Wrongly typed fields (a string priority, a list budget, unhashable or
    wrongly typed resume fields) cost the sender an error line each, never an
    exception through ``step()``; the next honest submit is served."""
    def drill(pkg, cfg):
        front = pkg.NetFront(FakeEngine(cfg), make_sample=lambda m: m["sample"])
        client = pkg.NetClient(front.address)
        client.step()
        for line in (b'{"sample": [1], "priority": "high"}',
                     b'{"sample": [1], "max_new_tokens": [9]}',
                     b'{"resume": [1], "have_seq": 0}', b'{"resume": {"x": 1}}',
                     b'{"resume": 0, "have_seq": "zero"}', b'[1, 2]', b'{"sample": null}'):
            client.send_garbage(line)
        tag = client.submit([4, 5])
        _drive(front, client)
        rec = _record(pkg, cfg, front, client)
        front.close()
        client.close()
        return rec, tag

    rec, tag = _both(cfgs, drill)
    assert rec["counters"]["malformed"] == 7 and rec["counters"]["disconnects"] == 0
    assert rec["events"].count("net.malformed") == 7
    assert rec["streams"][tag][1:4] == ([4, 5], True, "OK")


def test_heartbeats_on_the_injected_clock(cfgs):
    """``serve_net_heartbeat_s`` pulses ``{"hb": tick}`` on the injected
    clock, and never while the clock stands still."""
    def drill(pkg, cfg):
        clk = FakeClock()
        c = cfg.replace(serve_net_heartbeat_s=1.0)
        front = pkg.NetFront(FakeEngine(c, clock=clk), make_sample=lambda m: m["sample"],
                             clock=clk)
        client = pkg.NetClient(front.address, clock=clk)
        client.step()
        front.step()
        for _ in range(10):  # the clock stands still: no pulse
            front.step()
            client.step()
        still = client.hb_seen
        for _ in range(5):
            clk.t += 1.1
            front.step()
            client.step()
        rec = _record(pkg, c, front, client)
        front.close()
        client.close()
        return rec, still

    rec, still = _both(cfgs, drill)
    assert still == 0 and rec["client"][3] >= 4 and rec["client"][4] == 0


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def _wedge(front, pkg, sample, tag="w"):
    """A raw socket with a tiny receive buffer that submits and never reads."""
    wedge = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    wedge.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
    wedge.connect(front.address)
    wedge.sendall(pkg.encode_frame({"sample": sample, "tag": tag}))
    return wedge


def test_wedged_reader_stalls_then_drops(cfgs):
    """A reader that never drains: once the kernel buffers back up into the
    bounded buffer the connection is stalled (``net.stall``), and past
    ``serve_net_stall_timeout_s`` on the injected clock it is dropped with
    ``net.stall_drop`` while its stream lives on for a resume."""
    def drill(pkg, cfg):
        c = cfg.replace(serve_net_client_buffer=512, serve_net_frame_ring=100000,
                        serve_net_stall_timeout_s=5.0)
        clk = FakeClock()
        front = pkg.NetFront(FakeEngine(c, per_tick=0, clock=clk),
                             make_sample=lambda m: m["sample"], clock=clk)
        wedge = _wedge(front, pkg, list(range(8)))
        for _ in range(50):
            front.step()
            if front._streams:
                break
        assert 0 in front._streams
        front._conns[0].sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1024)
        s = front._streams[0]
        for _ in range(256):
            front._push_frame(s, {"tokens": list(range(250))})
        stalled = False
        for _ in range(400):
            front._flush()
            if front._conns and front._conns[0].stalled_since is not None:
                stalled = True
                break
        names = [e[1] for e in front.obs.events()]
        before = ("net.stall" in names, "net.stall_drop" in names,
                  front.counters["stall_drops"], len(front._conns))
        clk.t += c.serve_net_stall_timeout_s + 1.0
        front._flush()
        after = (front.counters["stall_drops"], len(front._conns), 0 in front._streams,
                 "net.stall_drop" in [e[1] for e in front.obs.events()])
        wedge.close()
        front.close()
        return stalled, before, after

    stalled, before, after = _both(cfgs, drill)
    assert stalled and before == (True, False, 0, 1)
    assert after == (1, 0, True, True)


def test_stalled_reader_unstalls_once_it_reads(cfgs):
    """A reader that stops and then drains again: stalled (``net.stall``),
    it reads on while the injected clock stands still, the front sends
    again (``net.unstall``; every later stall ends too, no drop), and the
    stream's every frame reaches it once, in seq order."""
    def drill(pkg, cfg):
        c = cfg.replace(serve_net_client_buffer=512, serve_net_frame_ring=100000,
                        serve_net_stall_timeout_s=5.0)
        clk = FakeClock()
        front = pkg.NetFront(FakeEngine(c, per_tick=0, clock=clk),
                             make_sample=lambda m: m["sample"], clock=clk)
        wedge = _wedge(front, pkg, list(range(8)))
        for _ in range(50):
            front.step()
            if front._streams:
                break
        front._conns[0].sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1024)
        s = front._streams[0]
        for _ in range(256):
            front._push_frame(s, {"tokens": list(range(250))})
        for _ in range(400):
            front._flush()
            if front._conns[0].stalled_since is not None:
                break
        stalled = [e[1] for e in front.obs.events()].count("net.stall")
        wedge.setblocking(False)
        buf, deadline = b"", time.monotonic() + 60.0
        while (front._conns[0].out or front._conns[0].cursors.get(0, s.next_seq) < s.next_seq
               or buf.count(b"\n") < s.next_seq) and time.monotonic() < deadline:
            try:
                buf += wedge.recv(65536)
            except (BlockingIOError, InterruptedError):
                time.sleep(0.001)
            front._flush()
        names = [e[1] for e in front.obs.events()]
        seqs = [json.loads(line).get("seq") for line in buf.split(b"\n")[:-1]]
        # the reader's pace decides how often it stalls again: each stall ends
        rec = dict(stalled=stalled, unstalled=names.count("net.unstall") >= 1,
                   each_stall_ended=names.count("net.stall") == names.count("net.unstall"),
                   drops=front.counters["stall_drops"], conns=len(front._conns),
                   seqs_in_order=seqs == list(range(s.next_seq)))
        wedge.close()
        front.close()
        return rec

    rec = _both(cfgs, drill)
    assert rec == dict(stalled=1, unstalled=True, each_stall_ended=True, drops=0, conns=1,
                       seqs_in_order=True)


def test_wedged_reader_costs_only_its_own_frames(cfgs):
    """The port's twin of JAX's wedged-reader latency drill, in counts on an
    injected clock: with a wedged reader mid-stream, every ``step()``
    returns (no send blocks: the stalled connection's buffer stays within
    the bound plus one step's frames), a second client's stream finishes
    with every token, the wedged stream finishes too, and the stalled
    connection is the only one dropped, past its timeout."""
    def drill(pkg, cfg):
        c = cfg.replace(serve_net_client_buffer=256, serve_net_frame_ring=100000,
                        serve_net_stall_timeout_s=2.0, serve_net_frame_tokens=1)
        clk = FakeClock()
        front = pkg.NetFront(FakeEngine(c, per_tick=3, clock=clk),
                             make_sample=lambda m: m["sample"], clock=clk)
        wedge = _wedge(front, pkg, list(range(4000)))
        for _ in range(50):
            front.step()
            if front._conns and front._streams:
                break
        front._conns[0].sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1024)
        client = pkg.NetClient(front.address, clock=clk)
        tag = client.submit(list(range(100, 160)))
        worst, steps, stalled_at = 0, 0, None
        for _ in range(3000):
            front.step()
            client.step()
            steps += 1
            clk.t += 0.01
            wedged = [x for x in front._conns if x.cursors.get(0) is not None]
            if wedged:
                worst = max(worst, len(wedged[0].out))
                if stalled_at is None and wedged[0].stalled_since is not None:
                    stalled_at = steps
            if client.pending() == 0 and not front._streams:
                break
        s = client.streams[tag]
        rec = dict(tokens=list(s.tokens), status=s.status, steps=steps, stalled_at=stalled_at,
                   worst_over_bound=worst - c.serve_net_client_buffer,
                   drops=front.counters["stall_drops"],
                   done=0 not in front._streams, conns=len(front._conns),
                   reasons=[f.get("reason") for _, n, _, f in front.obs.events()
                            if n == "net.disconnect"])
        wedge.close()
        client.close()
        front.close()
        return rec

    rec = _both(cfgs, drill)
    assert rec["tokens"] == list(range(100, 160)) and rec["status"] == "OK"
    assert rec["stalled_at"] is not None and rec["done"]
    assert 0 < rec["worst_over_bound"] < 65536  # one send window past the bound at most
    assert rec["drops"] == 1 and rec["reasons"] == ["stall"] and rec["conns"] == 1


# ---------------------------------------------------------------------------
# exactly-once delivery
# ---------------------------------------------------------------------------


def test_resume_exactly_once_across_reconnects(cfgs):
    """Three mid-stream disconnects: the client reconnects and resumes with
    ``have_seq``; every assembly lands with no duplicate and no lost token."""
    toks = [[100 + 10 * j + k for k in range(8)] for j in range(3)]

    def drill(pkg, cfg):
        front = pkg.NetFront(FakeEngine(cfg, per_tick=1), make_sample=lambda m: m["sample"])
        client = pkg.NetClient(front.address)
        tags = [client.submit(t) for t in toks]
        for i in range(300):
            front.step()
            client.step()
            if i in (2, 4, 6):
                client.disconnect()
            if client.pending() == 0 and not front._streams:
                break
        front.step()
        client.step()
        rec = _record(pkg, cfg, front, client)
        front.close()
        client.close()
        return rec, tags

    rec, tags = _both(cfgs, drill)
    reconnects, resumes = rec["client"][:2]
    assert reconnects >= 4 and resumes > 0 and rec["counters"]["resumes"] == resumes
    assert rec["violations"] == []
    for tag, t in zip(tags, toks):
        assert rec["streams"][tag][1:4] == (t, True, "OK")
        assert rec["streams"][tag][9:11] == (0, 0)  # no dups, no gaps


def test_resume_unknown_terminates_the_stream_lost(cfgs):
    """A server that no longer knows a stream (a restart) answers its resume
    with an error line: the client marks it lost and stops pending."""
    def drill(pkg, cfg):
        front = pkg.NetFront(FakeEngine(cfg, per_tick=1), make_sample=lambda m: m["sample"])
        host, port = front.address
        client = pkg.NetClient(front.address)
        tag = client.submit(list(range(50)))
        for _ in range(3):
            front.step()
            client.step()
        s = client.streams[tag]
        acked = s.id is not None and not s.done
        front.close()
        front2 = pkg.NetFront(FakeEngine(cfg), make_sample=lambda m: m["sample"],
                              host=host, port=port)
        _drive(front2, client)
        rec = (acked, s.lost, s.done, client.pending(), s.id in client.results(),
               "net.resume_unknown" in [e[1] for e in front2.obs.events()])
        front2.close()
        client.close()
        return rec

    assert _both(cfgs, drill) == (True, True, False, 0, False, True)


def test_refusal_backoff_honours_the_retry_hint(cfgs):
    """A REJECTED terminal frame carrying ``retry_after_s`` 3.0 schedules the
    resubmit no earlier than the hint on a fake clock; past it the resubmit
    completes."""
    def drill(pkg, cfg):
        clk = FakeClock()
        front = pkg.NetFront(FakeEngine(cfg, reject_first=1, retry_hint=3.0, clock=clk),
                             make_sample=lambda m: m["sample"], clock=clk)
        client = pkg.NetClient(front.address, clock=clk, retries=1)
        tag = client.submit([5, 6, 7])
        for _ in range(10):
            front.step()
            client.step()
        first = _streams(client)[tag], client.retry_pending()
        clk.t = 2.9
        for _ in range(5):
            front.step()
            client.step()
        waiting = client.retry_pending(), client.streams[tag].status
        clk.t = 3.1
        _drive(front, client)
        rec = _record(pkg, cfg, front, client)
        front.close()
        client.close()
        return first, waiting, rec, tag

    first, waiting, rec, tag = _both(cfgs, drill)
    assert first[0][2:4] == (True, "REJECTED") and first[0][7] == 3.0 and first[1] == 1
    assert waiting == (1, "REJECTED")
    assert rec["client"][2] == [3.0] and rec["streams"][tag][1:4] == ([5, 6, 7], True, "OK")


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------


def test_drain_refuses_new_submits_and_flushes_terminals(cfgs):
    """``begin_drain`` refuses a new submit with a synthetic negative-id
    REJECTED frame carrying ``retry_after_s`` while the in-flight stream
    finishes; ``drain()`` closes everything."""
    def drill(pkg, cfg):
        c = cfg.replace(serve_retry_after_s=0.5)
        front = pkg.NetFront(FakeEngine(c, per_tick=1), make_sample=lambda m: m["sample"])
        client = pkg.NetClient(front.address)
        t1 = client.submit([1, 2, 3, 4])
        for _ in range(3):
            front.step()
            client.step()
        front.begin_drain()
        t2 = client.submit([9, 9])
        _drive(front, client)
        rec = _record(pkg, c, front, client)
        front.drain()
        closed = (front._lsock is None, len(front._conns))
        client.close()
        return rec, t1, t2, closed

    rec, t1, t2, closed = _both(cfgs, drill)
    s2 = rec["streams"][t2]
    assert s2[0] < 0 and s2[1:5] == ([], True, "REJECTED", 0)
    assert s2[7] == 0.5 and s2[8] == "draining"
    assert rec["streams"][t1][1:4] == ([1, 2, 3, 4], True, "OK")
    assert rec["counters"]["refused"] == 1 and closed == (True, 0)


def test_drain_refusal_flood_keeps_retention_bounded(cfgs):
    """A submit flood against a draining front: every submit refused, and the
    finished-stream retention stays within ``serve_net_done_retain``."""
    def drill(pkg, cfg):
        c = cfg.replace(serve_net_done_retain=4, serve_retry_after_s=0.5)
        front = pkg.NetFront(FakeEngine(c), make_sample=lambda m: m["sample"])
        client = pkg.NetClient(front.address)
        client.step()
        front.step()
        front.begin_drain()
        tags = []
        for i in range(12):
            tags.append(client.submit([i]))
            front.step()
            client.step()
        _drive(front, client)
        rec = _record(pkg, c, front, client), len(front._done)
        front.close()
        client.close()
        return rec, tags

    (rec, kept), tags = _both(cfgs, drill)
    assert rec["counters"]["refused"] == 12 and kept <= 4
    assert all(rec["streams"][t][2:4] == (True, "REJECTED") and rec["streams"][t][7] == 0.5
               for t in tags)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


class _BoomEngine:
    """An engine whose first tick dies mid-flight."""

    def __init__(self, cfg, closed):
        self.cfg = cfg
        self.clock = time.monotonic
        self.occupancy = 1
        self.queue_depth = 0
        self._closed = closed

    def tick(self):
        raise RuntimeError("boom mid-flight")

    def close(self):
        self._closed.append("close")

    def partial_tokens(self):
        return {}

    def poll(self, sid):
        return None


def _cli_args(**kw):
    return types.SimpleNamespace(**{**dict(slo=False, heartbeat_s=0.0, drain_deadline_s=1.0,
                                           max_new_tokens=8, net=True), **kw})


def test_cli_serve_net_crash_drains_the_front_and_flushes(cfgs, monkeypatch):
    """A crash inside the ``--net`` loop unwinds through the front's drain
    (its socket closed), ``engine.close()`` and the telemetry's finalize,
    in that order."""
    import csat_tpu_torch.serve.netfront as netfront_mod
    from csat_tpu_torch.serve import cli

    ran, created = [], []
    eng = _BoomEngine(cfgs["port"], ran)
    orig = netfront_mod.NetFront.__init__

    def capture(self, *a, **k):
        orig(self, *a, **k)
        created.append(self)

    monkeypatch.setattr(netfront_mod.NetFront, "__init__", capture)
    monkeypatch.setattr(cli, "build_engine", lambda a: (eng, cfgs["port"], None, None))
    monkeypatch.setattr(cli, "_telemetry",
                        lambda e, c, a: (None, dict, lambda: ran.append("finalize")))
    with pytest.raises(RuntimeError, match="boom"):
        cli._serve_net(_cli_args())
    assert ran == ["close", "finalize"]
    assert created and created[0]._lsock is None


def test_cli_net_flag_routes_to_the_front_door(monkeypatch):
    """``serve --net`` runs the front door's loop, ``serve`` the stdin loop;
    the ``--net_*`` flags parse with JAX's defaults."""
    from csat_tpu_torch.serve import cli

    routed = []
    monkeypatch.setattr(cli, "_serve_net", lambda a: routed.append(("net", a.net_port)))
    monkeypatch.setattr(cli, "_serve", lambda a: routed.append(("stdin", a.net_port)))
    cli.main(["serve", "--config", "python", "--net", "--net_port", "0"])
    cli.main(["serve", "--config", "python"])
    assert routed == [("net", 0), ("stdin", -1)]
    args = cli._parser().parse_args(["--config", "python"])
    assert (args.net, args.slo, args.net_host, args.net_client_buffer,
            args.net_stall_timeout_s, args.net_heartbeat_s) == (False, False, "", 0, -1.0, -1.0)


def test_cli_net_flags_override_the_config(monkeypatch):
    """``--net_host`` / ``--net_port`` / ``--net_client_buffer`` /
    ``--net_stall_timeout_s`` / ``--net_heartbeat_s`` land on the
    ``serve_net_*`` fields, unset flags keep the config's, and a value the
    config's rules refuse exits with its one line."""
    from csat_tpu_torch.serve import cli

    from csat_tpu_torch.configs import cli_config

    seen = []

    def fake_cli_config(name, overrides):
        seen.append(cli_config(name, overrides))
        raise SystemExit("stop")

    monkeypatch.setattr("csat_tpu_torch.configs.cli_config", fake_cli_config)
    base = ["--config", "python", "--device", "cpu"]
    for extra in ([], ["--net_host", "0.0.0.0", "--net_port", "7", "--net_client_buffer",
                       "4096", "--net_stall_timeout_s", "0", "--net_heartbeat_s", "0.5"]):
        with pytest.raises(SystemExit, match="stop"):
            cli.build_engine(cli._parser().parse_args(base + extra))
    fields = ("serve_net_host", "serve_net_port", "serve_net_client_buffer",
              "serve_net_stall_timeout_s", "serve_net_heartbeat_s")
    assert [getattr(seen[0], f) for f in fields] == ["127.0.0.1", 0, 65536, 5.0, 0.0]
    assert [getattr(seen[1], f) for f in fields] == ["0.0.0.0", 7, 4096, 0.0, 0.5]
    monkeypatch.undo()
    with pytest.raises(SystemExit, match="^python: -3$"):
        cli.build_engine(cli._parser().parse_args(base + ["--net_client_buffer", "-3"]))


def test_cli_front_answers_refused_snippets_failed(cfgs):
    """The command line's front door: a snippet that ingest refuses gets an
    ACK and a terminal FAILED frame with the error under a negative id (the
    stdin loop answers it FAILED), its tag echoed, counted as no refusal; a non-string ``sample``
    stays a malformed line as in JAX; a parseable snippet is submitted."""
    from csat_tpu_torch.data.vocab import Vocab
    from csat_tpu_torch.serve import cli
    from csat_tpu_torch.serve.netclient import NetClient

    cfg = cfgs["port"]
    vocab = Vocab(need_bos=False)
    submitted = []
    eng = FakeEngine(cfg)
    real = eng.submit
    eng.submit = lambda sample, **kw: (submitted.append(int(sample["num_node"])),
                                       real([1, 2, 3], **kw))[1]
    front = cli._net_front(eng, cfg, vocab, None)
    client = NetClient(front.address)
    bad = client.submit("def f(:\n", priority=2)
    good = client.submit("def f(x):\n    return x\n")
    client.step()
    client.send_garbage(b'{"sample": 5}')
    _drive(front, client)
    b, g = client.streams[bad], client.streams[good]
    assert b.done and b.status == "FAILED" and b.id < 0 and b.tokens == []
    assert b.error.startswith("SyntaxError") and b.priority == 2
    assert g.done and g.status == "OK" and g.tokens == [1, 2, 3] and submitted[0] > 1
    assert front.counters["refused"] == 0 and front.counters["malformed"] == 1
    done = [e[3] for e in front.obs.events() if e[1] == "net.stream_done"]
    assert sorted(d["status"] for d in done) == ["FAILED", "OK"]
    assert front.summary()["done_streams"] == 2
    front.close()
    client.close()
