"""Streaming network front door: JSONL token frames over loopback TCP — the
JAX package's ``serve/netfront.py`` for the port (``tests/test_torch_imports.py``
holds every definition to the original's).

``python -m csat_tpu_torch.cli serve --net`` puts this in front of a
:class:`~csat_tpu_torch.serve.engine.ServeEngine` or a
:class:`~csat_tpu_torch.serve.fleet.Fleet`.  One single-threaded,
non-blocking socket loop owns the protocol boundary; the engine's tick never
blocks on a socket write — a slow reader pauses only its own stream.

Wire protocol (one JSON object per line, both directions):

* client → server submit: ``{"sample": <payload>, "tag": str?,
  "priority": int?, "max_new_tokens": int?}`` — ``sample`` is opaque to the
  front; the injected ``make_sample`` callable turns it into an engine
  sample (the CLI wires the JSONL ingest path, tests pass prebuilt samples
  by index).
* client → server resume: ``{"resume": <id>, "have_seq": n}`` — replay every
  frame with seq > ``have_seq`` from the stream's bounded frame ring.  A
  stream outlives its connection: any later connection may adopt it, which
  makes delivery exactly-once at the token level across reconnects.
* server → client frame: ``{"id", "seq", "tokens", done?, status?}``.  Frame
  0 is the ACK (empty ``tokens``; echoes ``tag`` and the clamped
  ``priority``).  The terminal frame carries ``done: true``, the terminal
  ``status``, the authoritative ``n_tokens`` (clients truncate to it — a
  FAILED stream may have streamed a since-retracted suffix), a ``browned``
  marker when the decode budget was brownout-capped, and on refusals the
  ``retry_after_s`` backpressure hint.
* server → client heartbeat: ``{"hb": <engine tick>}`` every
  ``serve_net_heartbeat_s`` (0 disables).

Backpressure: frames queue in the per-stream ring; a connection's send buffer
is bounded by ``serve_net_client_buffer`` bytes.  Beyond the bound the
connection is stalled (``net.stall``, gauge ``serve_net_stalled``) and no
more frames are appended for it; past ``serve_net_stall_timeout_s`` it is
dropped with a structured ``net.stall_drop``.  The stream itself is
untouched — the client reconnects and resumes.

Drain: :meth:`begin_drain` stops new connections and refuses new submissions
(terminal REJECTED frames carrying ``retry_after_s``); :meth:`drain` then
steps until every in-flight stream has flushed its terminal frame (or
force-sheds at the step cap) before closing.

Everything here is host-side socket work between engine ticks, through the
engine's or fleet's public surface (``submit`` / ``poll`` / ``pop_result`` /
``tick`` / ``partial_tokens`` / ``stats``).  The one device read it adds is
the engine's: ``partial_tokens`` copies the token pool to the host once per
step while a stream is live.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from csat_tpu_torch.obs import EventRecorder
from csat_tpu_torch.serve.engine import RequestStatus

__all__ = ["NetFront", "encode_frame"]

# recv chunk per read attempt; reads loop until EWOULDBLOCK either way
_RECV_CHUNK = 65536

# force-shed cap for drain(): generous — a drain that needs more steps
# than this has a wedged engine, and the remaining streams get terminal
# SHED frames instead of hanging the process
_DRAIN_STEP_CAP = 50_000


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """One wire line: compact JSON + newline (UTF-8)."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode("utf-8")


class _Stream:
    """Server-side record of one request's frame stream.

    ``frames`` is the bounded replay ring (serialized lines;
    ``frames[0]`` has seq ``base_seq``); ``tokens`` is the authoritative
    token list — streamed prefix while live, the engine's final
    ``req.tokens`` once terminal — which the stream invariants
    (``stream_no_token_loss``) compare client assemblies against."""

    __slots__ = ("id", "tag", "priority", "frames", "base_seq", "next_seq",
                 "sent_tokens", "done", "status", "tokens", "browned",
                 "req")

    def __init__(self, sid: int, tag: Optional[str], priority: int):
        self.id = sid
        self.tag = tag
        self.priority = priority
        self.frames: List[bytes] = []
        self.base_seq = 0
        self.next_seq = 0
        self.sent_tokens = 0
        self.done = False
        self.status = ""
        self.tokens: List[int] = []
        self.browned = False
        self.req: Optional[Any] = None  # terminal Request (retained done)


class _Conn:
    """One client connection: line-buffered input, bounded output, and a
    per-stream send cursor (next seq to copy out of the stream ring)."""

    __slots__ = ("sock", "inbuf", "out", "cursors", "stalled_since", "t0",
                 "closed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.out = bytearray()
        self.cursors: Dict[int, int] = {}
        self.stalled_since: Optional[float] = None
        self.t0 = time.perf_counter()  # connection-lifetime span base
        self.closed = False


class NetFront:
    """Socket/JSONL front door over one engine or fleet.

    Single-threaded: the owner calls :meth:`step` in a loop (the CLI's
    serve loop, the chaos loop, the bench).  Each step services
    sockets, ticks the target while it has work, frames newly decoded
    tokens, and flushes per-connection output — in that order, so a
    wedged reader costs one failed ``send()`` and nothing else."""

    def __init__(
        self,
        target: Any,
        make_sample: Callable[[Dict[str, Any]], Any],
        host: Optional[str] = None,
        port: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.target = target
        self.cfg = target.cfg
        self.make_sample = make_sample
        self.clock: Callable[[], float] = (
            clock if clock is not None
            else getattr(target, "clock", time.monotonic))
        self.obs = EventRecorder(capacity=self.cfg.obs_events,
                                 component="net")
        # engine exposes .stats; a fleet's replica 0 carries the scrape
        # surface the obs-report/top net columns read (fleet-level net
        # counters are front-door-global either way)
        self._stats = getattr(target, "stats", None)
        if self._stats is None and getattr(target, "replicas", None):
            self._stats = target.replicas[0].engine.stats
        self.counters: Dict[str, int] = {
            "connects": 0, "disconnects": 0, "frames": 0, "resumes": 0,
            "stall_drops": 0, "malformed": 0, "refused": 0}
        self._conns: List[_Conn] = []
        self._streams: Dict[int, _Stream] = {}   # live (non-terminal)
        self._done: Dict[int, _Stream] = {}      # bounded FIFO retention
        self._refuse_id = 0                      # synthetic drain-refusal ids
        self._last_hb = self.clock()
        self.draining = False
        self._lsock: Optional[socket.socket] = socket.socket(
            socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((
            host if host is not None else self.cfg.serve_net_host,
            port if port is not None else self.cfg.serve_net_port))
        self._lsock.listen(128)
        self._lsock.setblocking(False)
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self.obs.emit("net.listen", host=self.address[0],
                      port=self.address[1])

    # ---------------- bookkeeping ----------------

    def _count(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta
        stat = {"frames": "net_frames", "resumes": "net_resumes",
                "stall_drops": "net_stall_drops",
                "disconnects": "net_disconnects",
                "malformed": "net_malformed"}.get(name)
        if stat is not None and self._stats is not None:
            setattr(self._stats, stat, getattr(self._stats, stat) + delta)

    def _gauges(self) -> None:
        if self._stats is not None:
            self._stats.net_connections = len(self._conns)
            self._stats.net_stalled = sum(
                1 for c in self._conns if c.stalled_since is not None)

    def streams(self) -> Dict[int, List[int]]:
        """Authoritative token list per stream id (live + retained done)
        — what :meth:`InvariantMonitor.check_streams` compares client
        assemblies against."""
        out = {sid: list(st.tokens) for sid, st in self._done.items()}
        out.update({sid: list(st.tokens)
                    for sid, st in self._streams.items()})
        return out

    def results(self) -> Dict[int, Any]:
        """Terminal :class:`Request` per retained engine-backed stream
        (synthetic drain refusals excluded) — what ``run_net_chaos``
        feeds :meth:`InvariantMonitor.check`."""
        return {sid: st.req for sid, st in self._done.items()
                if sid >= 0 and st.req is not None}

    def stream_status(self) -> Dict[int, str]:
        """Terminal status per retained stream id ('' while live)."""
        out = {sid: st.status for sid, st in self._done.items()}
        out.update({sid: st.status for sid, st in self._streams.items()})
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "address": list(self.address),
            "connections": len(self._conns),
            "live_streams": len(self._streams),
            "done_streams": len(self._done),
            **self.counters,
        }

    # ---------------- frames ----------------

    def _push_frame(self, st: _Stream, payload: Dict[str, Any]) -> None:
        payload["id"] = st.id
        payload["seq"] = st.next_seq  # csat-lint: disable=mesh-axis-literal wire-protocol frame key, not a mesh axis
        st.next_seq += 1
        st.frames.append(encode_frame(payload))
        ring = self.cfg.serve_net_frame_ring
        while len(st.frames) > ring:
            # memory bound wins over replayability: a resume below the
            # new base_seq gets a reset line and the client marks the
            # stream lost (never silently re-sequenced)
            st.frames.pop(0)
            st.base_seq += 1
        self._count("frames")

    def _frame_tokens(self, st: _Stream, toks: List[int]) -> None:
        chunk = self.cfg.serve_net_frame_tokens
        if chunk <= 0:
            chunk = len(toks)
        i = 0
        while i < len(toks):
            part = toks[i:i + chunk]
            self._push_frame(st, {"tokens": part})
            st.tokens.extend(part)
            st.sent_tokens += len(part)
            i += len(part)

    def _retain_done(self, st: _Stream) -> None:
        """Move a terminal stream into the bounded ``_done`` retention
        FIFO — every insertion path shares this trim, so a submit flood
        of drain refusals can't grow retention without bound."""
        self._done[st.id] = st
        while len(self._done) > self.cfg.serve_net_done_retain:
            self._done.pop(next(iter(self._done)))

    def _finish_stream(self, st: _Stream, req: Any) -> None:
        full: List[int] = (
            [int(t) for t in req.tokens.tolist()]
            if req.tokens is not None else [])
        if len(full) > st.sent_tokens:
            # remainder delivered at retirement (terminal partials, the
            # final tokens of an OK request) — stream it before done
            self._frame_tokens(st, full[st.sent_tokens:])
        st.tokens = full  # engine's final tokens are authoritative
        st.done = True
        st.status = req.status
        st.req = req
        st.browned = bool(getattr(req, "browned", False))
        term: Dict[str, Any] = {
            "tokens": [], "done": True, "status": req.status,
            "n_tokens": len(full), "priority": int(req.priority)}
        if st.browned:
            term["browned"] = True
        if getattr(req, "retry_after_s", None) is not None:
            term["retry_after_s"] = float(req.retry_after_s)
        if req.error:
            term["error"] = str(req.error)
        self._push_frame(st, term)
        self._streams.pop(st.id, None)
        self._retain_done(st)
        self.obs.emit("net.stream_done", id=st.id, status=req.status,
                      n_tokens=len(full), frames=st.next_seq)

    # ---------------- inbound ----------------

    def _note_malformed(self, conn: _Conn, detail: str) -> None:
        self._count("malformed")
        self.obs.emit("net.malformed", detail=detail)
        conn.out += encode_frame({"error": "malformed", "detail": detail})

    def _refusal(self, conn: _Conn, tag: Optional[str], priority: int,
                 error: str) -> None:
        """Terminal refusal without an engine submit (drain path): a
        synthetic negative id keeps the one-ack-one-terminal frame shape
        clients already handle."""
        self._refuse_id -= 1
        st = _Stream(self._refuse_id, tag, priority)
        ack: Dict[str, Any] = {"tokens": [], "priority": priority}
        if tag is not None:
            ack["tag"] = tag
        self._push_frame(st, ack)
        hint = self.cfg.serve_retry_after_s
        term: Dict[str, Any] = {
            "tokens": [], "done": True, "status": RequestStatus.REJECTED,
            "n_tokens": 0, "priority": priority, "error": error}
        if hint and hint > 0:
            term["retry_after_s"] = float(hint)
        self._push_frame(st, term)
        st.done = True
        st.status = RequestStatus.REJECTED
        conn.cursors[st.id] = 0
        self._retain_done(st)
        self._count("refused")
        self.obs.emit("net.refuse", error=error, priority=priority)

    def _handle_submit(self, conn: _Conn, msg: Dict[str, Any]) -> None:
        tag = msg.get("tag")
        try:
            priority = int(msg.get("priority", 0))
            max_new = int(msg.get("max_new_tokens", 0))
        except (TypeError, ValueError):
            self._note_malformed(conn, "bad priority/max_new_tokens")
            return
        if self.draining:
            self._refusal(conn, tag, priority, "draining")
            return
        try:
            sample = self.make_sample(msg)
        except Exception as e:  # client-supplied payload: never fatal
            self._note_malformed(conn, f"bad sample: {e}")
            return
        if sample is None:
            self._note_malformed(conn, "bad sample: no payload")
            return
        try:
            sid = self.target.submit(
                sample, max_new_tokens=max_new, priority=priority)
        except Exception as e:
            # poison-budget exhaustion (DataErrorBudgetExceeded) and kin:
            # the front door stays up — the caller gets a structured
            # refusal, never a torn half-stream
            self.obs.emit("net.submit_fail", error=str(e))
            self._refusal(conn, tag, priority, f"submit failed: {e}")
            return
        st = _Stream(sid, tag, priority)
        self._streams[sid] = st
        conn.cursors[sid] = 0
        req = self.target.poll(sid)
        ack_priority = int(req.priority) if req is not None else priority
        ack: Dict[str, Any] = {"tokens": [], "priority": ack_priority}
        if tag is not None:
            ack["tag"] = tag
        self._push_frame(st, ack)
        self.obs.emit("net.submit", id=sid, priority=ack_priority,
                      **({"tag": tag} if tag is not None else {}))
        if req is not None:
            # terminal at submit (REJECTED/SHED/poison-FAILED): the
            # refusal frame carries retry_after_s + the priority echo
            self.target.pop_result(sid)
            self._finish_stream(st, req)

    def _handle_resume(self, conn: _Conn, msg: Dict[str, Any]) -> None:
        sid = msg.get("resume")
        # stream ids are ints end to end; anything else is a protocol
        # violation (an unhashable sid would otherwise blow up the dict
        # lookups below and take the serve loop down with it)
        if not isinstance(sid, int) or isinstance(sid, bool):
            self._note_malformed(conn, "bad resume id")
            return
        try:
            have = int(msg.get("have_seq", -1))
        except (TypeError, ValueError):
            self._note_malformed(conn, "bad have_seq")
            return
        st = self._streams.get(sid)
        if st is None:
            st = self._done.get(sid)
        if st is None:
            conn.out += encode_frame({"resume": sid, "error": "unknown"})
            self.obs.emit("net.resume_unknown", id=sid)
            return
        conn.cursors[sid] = max(st.base_seq, have + 1)
        self._count("resumes")
        self.obs.emit("net.resume", id=sid, have_seq=have,
                      replay_from=conn.cursors[sid])

    def _handle_line(self, conn: _Conn, raw: bytes) -> None:
        raw = raw.strip()
        if not raw:
            return
        try:
            msg = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._note_malformed(conn, "unparseable line")
            return
        if not isinstance(msg, dict):
            self._note_malformed(conn, "not an object")
            return
        try:
            if "resume" in msg:
                self._handle_resume(conn, msg)
            elif "sample" in msg:
                self._handle_submit(conn, msg)
            elif "hb" in msg:
                pass  # client heartbeat echo: liveness only
            else:
                self._note_malformed(conn, "unknown message")
        except Exception as e:
            # last-resort backstop for the module contract: a
            # client-supplied payload is NEVER fatal to the front door —
            # a wrong-typed field the handlers missed costs the sender
            # an error line, not every client the server
            self._note_malformed(conn, f"bad message: {e}")

    # ---------------- sockets ----------------

    def _accept(self) -> None:
        if self._lsock is None:
            return
        while True:
            try:
                s, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self.draining:
                try:
                    s.close()
                except OSError:
                    pass
                continue
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self._conns.append(_Conn(s))
            self._count("connects")
            self.obs.emit("net.connect", conns=len(self._conns))
            self._gauges()

    def _drop(self, conn: _Conn, reason: str) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn in self._conns:
            self._conns.remove(conn)
        self._count("disconnects")
        self.obs.emit("net.disconnect", reason=reason,
                      conns=len(self._conns))
        # connection lifetime as a span: stall forensics read these
        self.obs.span_from("net.conn", conn.t0, reason=reason)
        self._gauges()

    def _read(self, conn: _Conn) -> None:
        while not conn.closed:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop(conn, "peer_error")
                return
            if not data:
                self._drop(conn, "eof")
                return
            conn.inbuf += data
            if len(data) < _RECV_CHUNK:
                break
        while not conn.closed and b"\n" in conn.inbuf:
            line, _, rest = conn.inbuf.partition(b"\n")
            conn.inbuf = bytearray(rest)
            self._handle_line(conn, bytes(line))

    def _flush(self) -> None:
        now = self.clock()
        bound = self.cfg.serve_net_client_buffer
        for conn in list(self._conns):
            if conn.closed:
                continue
            # copy owed frames out of the stream rings, up to the bound
            for sid in list(conn.cursors):
                if len(conn.out) > bound:
                    break
                st = self._streams.get(sid)
                if st is None:
                    st = self._done.get(sid)
                if st is None:
                    conn.cursors.pop(sid)
                    continue
                cursor = conn.cursors[sid]
                if cursor < st.base_seq:
                    # ring trimmed past this reader: tell it honestly
                    conn.out += encode_frame(
                        {"id": sid, "reset": st.base_seq})
                    self.obs.emit("net.ring_gap", id=sid, cursor=cursor,
                                  base_seq=st.base_seq)
                    cursor = st.base_seq
                while cursor < st.next_seq and len(conn.out) <= bound:
                    conn.out += st.frames[cursor - st.base_seq]
                    cursor += 1
                conn.cursors[sid] = cursor
                if st.done and cursor >= st.next_seq:
                    conn.cursors.pop(sid)
            if conn.out:
                try:
                    n = conn.sock.send(
                        memoryview(conn.out)[:_RECV_CHUNK])
                    del conn.out[:n]
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    self._drop(conn, "peer_error")
                    continue
            # stall accounting AFTER the send attempt: over the bound
            # means the kernel buffer is full too (the reader is wedged)
            if len(conn.out) > bound:
                if conn.stalled_since is None:
                    conn.stalled_since = now
                    self.obs.emit("net.stall", buffered=len(conn.out))
                elif (now - conn.stalled_since
                      > self.cfg.serve_net_stall_timeout_s):
                    self._count("stall_drops")
                    self.obs.emit(
                        "net.stall_drop", buffered=len(conn.out),
                        stalled_s=round(now - conn.stalled_since, 3))
                    self._drop(conn, "stall")
                    continue
            elif conn.stalled_since is not None:
                conn.stalled_since = None
                self.obs.emit("net.unstall")
        self._gauges()

    def _heartbeat(self) -> None:
        hb = self.cfg.serve_net_heartbeat_s
        if hb <= 0:
            return
        now = self.clock()
        if now - self._last_hb < hb:
            return
        self._last_hb = now
        line = encode_frame({"hb": int(getattr(self.target, "ticks", 0))})
        for conn in self._conns:
            if conn.stalled_since is None:
                conn.out += line

    # ---------------- driving ----------------

    def step(self, tick: bool = True) -> int:
        """One service round: accept, read, tick the target while it has
        work, frame newly decoded tokens, flush.  Returns the number of
        live (non-terminal) streams."""
        self._accept()
        for conn in list(self._conns):
            self._read(conn)
        if tick and (self._streams or self.target.queue_depth > 0
                     or self.target.occupancy > 0):
            self.target.tick()
        if self._streams:
            self._pump()
        self._heartbeat()
        self._flush()
        return len(self._streams)

    def _pump(self) -> None:
        partial = self.target.partial_tokens()
        for st in list(self._streams.values()):
            cur = partial.get(st.id)
            if cur is not None and len(cur) > st.sent_tokens:
                self._frame_tokens(
                    st, [int(t) for t in cur[st.sent_tokens:].tolist()])
            req = self.target.poll(st.id)
            if req is not None:
                self.target.pop_result(st.id)
                self._finish_stream(st, req)

    # ---------------- drain / close ----------------

    def begin_drain(self) -> None:
        """SIGTERM posture: no new connections or submissions; in-flight
        streams keep streaming until done."""
        if not self.draining:
            self.draining = True
            self.obs.emit("net.drain", streams=len(self._streams),
                          conns=len(self._conns))

    def drain(self, max_steps: int = _DRAIN_STEP_CAP) -> None:
        """Drain to completion: step until every stream has flushed its
        terminal frame, force-shedding stragglers at the cap, then give
        connected readers a last flush and close."""
        self.begin_drain()
        steps = 0
        while self._streams and steps < max_steps:
            self.step()
            steps += 1
        for st in list(self._streams.values()):
            # wedged engine past the cap: honest terminal frames anyway
            term = {"tokens": [], "done": True,
                    "status": RequestStatus.SHED,
                    "n_tokens": len(st.tokens),
                    "priority": st.priority, "error": "drain cap"}
            self._push_frame(st, term)
            st.done = True
            st.status = RequestStatus.SHED
            self._streams.pop(st.id, None)
            self._retain_done(st)
        for _ in range(8):
            if not any(c.out or c.cursors for c in self._conns):
                break
            self._flush()
        self.close()

    def close(self) -> None:
        for conn in list(self._conns):
            self._drop(conn, "close")
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None
        self.obs.emit("net.close", **self.counters)
