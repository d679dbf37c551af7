"""Backpressure-aware streaming client of the network front door — the JAX
package's ``serve/netclient.py`` for the port (``tests/test_torch_imports.py``
holds every definition to the original's).

It connects over loopback TCP, submits requests as JSONL, assembles each
request's tokens from ``{id, seq, tokens, done?, status?}`` frames, and
lives through the network fault family honestly:

* **reconnect and resume**: after a drop (a server stall-drop, a chaos
  ``disconnect_mid_stream``, a ``reconnect_storm``) the next :meth:`step`
  reconnects and sends ``{"resume": id, "have_seq": n}`` for every
  unterminated stream it knows the id of, and re-sends any submit that was
  never ACKed.  The server replays only frames after ``have_seq``, so
  assembly is exactly-once at the token level; the per-stream ``dups`` /
  ``gaps`` counters are the invariant monitor's evidence;
* **honest backoff**: a terminal REJECTED / SHED frame carrying
  ``retry_after_s`` schedules the resubmit no earlier than the hint
  (``retries`` > 0), on an injectable clock;
* **deliberate misbehaviour** (chaos hooks): ``max_read_bytes`` throttles
  reads (``slow_reader``: the server must stall-account, never block its
  tick), and :meth:`send_garbage` injects ``malformed_frame`` lines.

Pure stdlib: no torch, no numpy; tokens stay plain int lists.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["NetClient", "ClientStream"]

_RECV_CHUNK = 65536

#: The wire protocol's frame sequence-number key.  The client is
#: stdlib-only on purpose (usable without the server package), so the
#: spelling lives here rather than in a shared constants module.
_SEQ = "seq"  # csat-lint: disable=mesh-axis-literal wire-protocol frame key, not a mesh axis


class ClientStream:
    """Client-side assembly of one stream: contiguous frames only —
    a duplicate seq is counted and dropped, a gap marks the stream lost
    (it is never silently re-sequenced)."""

    __slots__ = ("tag", "id", "tokens", "have_seq", "done", "status",
                 "n_tokens", "priority", "browned", "retry_after_s",
                 "error", "dups", "gaps", "lost", "resumes")

    def __init__(self, tag: str):
        self.tag = tag
        self.id: Optional[int] = None
        self.tokens: List[int] = []
        self.have_seq = -1
        self.done = False
        self.status = ""
        self.n_tokens = 0
        self.priority = 0
        self.browned = False
        self.retry_after_s: Optional[float] = None
        self.error: Optional[str] = None
        self.dups = 0
        self.gaps = 0
        self.lost = False
        self.resumes = 0


class NetClient:
    """Step-driven JSONL streaming client (single-threaded co-sim: the
    caller interleaves ``front.step(); client.step()``).

    ``retries`` bounds automatic resubmission of refused requests; each
    retry waits at least the server's ``retry_after_s`` hint (measured
    on the injected ``clock``)."""

    def __init__(
        self,
        address: Tuple[str, int],
        clock: Callable[[], float] = time.monotonic,
        retries: int = 0,
        max_read_bytes: int = 0,
    ):
        self.address = (address[0], int(address[1]))
        self.clock = clock
        self.retries = int(retries)
        # slow_reader chaos: cap bytes read per step (0 = unthrottled)
        self.max_read_bytes = int(max_read_bytes)
        self.sock: Optional[socket.socket] = None
        self._out = bytearray()
        self._in = bytearray()
        self.streams: Dict[str, ClientStream] = {}   # by client tag
        self._by_id: Dict[int, ClientStream] = {}
        self._orphans: set = set()                   # superseded server ids
        self._submits: Dict[str, Dict[str, Any]] = {}  # tag → submit msg
        self._retries_left: Dict[str, int] = {}
        self._retry_at: Dict[str, float] = {}        # tag → earliest resubmit
        self._next_tag = 0
        self.reconnects = 0
        self.resumes_sent = 0
        self.backoffs: List[float] = []              # honored hint waits
        self.hb_seen = 0
        self.errors = 0                              # server error lines

    # ---------------- submitting ----------------

    def submit(self, payload: Any, priority: int = 0,
               max_new_tokens: int = 0, tag: Optional[str] = None) -> str:
        """Queue one submit; returns the client tag the stream is
        tracked under.  ``payload`` is the wire ``sample`` value — the
        server's ``make_sample`` interprets it."""
        if tag is None:
            tag = f"c{self._next_tag}"
            self._next_tag += 1
        msg = {"sample": payload, "tag": tag,
               "priority": int(priority),
               "max_new_tokens": int(max_new_tokens)}
        self.streams[tag] = ClientStream(tag)
        self._submits[tag] = msg
        self._retries_left[tag] = self.retries
        if self.sock is not None:
            # not yet connected: _connect() queues every un-ACKed submit
            # itself — queueing here too would submit the request twice
            self._queue_line(msg)
        return tag

    def send_garbage(self, line: bytes = b"{not json\n") -> None:
        """malformed_frame chaos: inject a protocol-violating line."""
        self._out += line if line.endswith(b"\n") else line + b"\n"

    def _queue_line(self, msg: Dict[str, Any]) -> None:
        self._out += (json.dumps(msg, separators=(",", ":"))
                      + "\n").encode("utf-8")

    # ---------------- connection ----------------

    def disconnect(self) -> None:
        """Drop the connection (chaos ``disconnect_mid_stream`` /
        ``reconnect_storm``); the next :meth:`step` reconnects and
        resumes every unterminated stream."""
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        self._in.clear()
        self._out.clear()

    def _connect(self) -> bool:
        try:
            s = socket.create_connection(self.address, timeout=1.0)
        except OSError:
            return False
        s.setblocking(False)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = s
        self.reconnects += 1
        # resume everything unterminated we hold an id for; re-send
        # submits that were never ACKed (no id yet, so no stream state
        # exists server-side to duplicate)
        for tag, st in self.streams.items():
            if st.done or st.lost:
                continue
            if st.id is not None:
                self._queue_line({"resume": st.id,
                                  "have_seq": st.have_seq})
                st.resumes += 1
                self.resumes_sent += 1
            elif tag in self._submits and tag not in self._retry_at:
                self._queue_line(self._submits[tag])
        return True

    # ---------------- stepping ----------------

    def step(self) -> int:
        """One client round: (re)connect, fire due backoff resubmits,
        send, read (throttled under slow_reader), parse frames.  Returns
        the number of unterminated streams."""
        now = self.clock()
        for tag in [t for t, at in self._retry_at.items() if at <= now]:
            at = self._retry_at.pop(tag)
            st = self.streams[tag]
            waited = st.retry_after_s
            if waited is not None:
                self.backoffs.append(float(waited))
            # fresh stream state for the new attempt; same tag
            self.streams[tag] = ClientStream(tag)
            if self.sock is not None:
                self._queue_line(self._submits[tag])  # else: _connect's job
        if self.sock is None and not self._connect():
            return self.pending()
        self._send()
        self._recv()
        while b"\n" in self._in:
            line, _, rest = self._in.partition(b"\n")
            self._in = bytearray(rest)
            self._handle_line(bytes(line))
        return self.pending()

    def pending(self) -> int:
        return sum(1 for st in self.streams.values()
                   if not st.done and not st.lost)

    def retry_pending(self) -> int:
        """Backoff resubmits scheduled but not yet fired (the caller
        keeps stepping until these drain too)."""
        return len(self._retry_at)

    def next_retry_in(self) -> Optional[float]:
        """Seconds (on the injected clock) until the earliest scheduled
        backoff resubmit fires — None when none are pending.  Callers
        use this to wait out a ``retry_after_s`` hint instead of
        spinning their step budget away."""
        if not self._retry_at:
            return None
        return max(0.0, min(self._retry_at.values()) - self.clock())

    def _send(self) -> None:
        if not self._out or self.sock is None:
            return
        try:
            n = self.sock.send(memoryview(self._out)[:_RECV_CHUNK])
            del self._out[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self.disconnect()

    def _recv(self) -> None:
        if self.sock is None:
            return
        budget = self.max_read_bytes if self.max_read_bytes > 0 else (
            1 << 30)
        while budget > 0:
            want = min(budget, _RECV_CHUNK)
            try:
                data = self.sock.recv(want)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.disconnect()
                return
            if not data:
                self.disconnect()
                return
            self._in += data
            budget -= len(data)
            if len(data) < want:
                return

    # ---------------- frames ----------------

    def _handle_line(self, raw: bytes) -> None:
        raw = raw.strip()
        if not raw:
            return
        try:
            msg = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self.errors += 1
            return
        if not isinstance(msg, dict):
            self.errors += 1
            return
        if "hb" in msg:
            self.hb_seen += 1
            return
        if "reset" in msg:
            st = self._by_id.get(msg.get("id"))
            if st is not None and not st.done:
                st.gaps += 1
                st.lost = True
            return
        if "error" in msg and _SEQ not in msg:
            sid = msg.get("resume")
            if isinstance(sid, int) and not isinstance(sid, bool):
                # resume refused ({"resume": sid, "error": "unknown"}):
                # the server evicted the stream past its done-retention
                # (or restarted) — the remaining frames are gone, so
                # terminate honestly instead of pending forever
                st = self._by_id.get(sid)
                if st is not None and not st.done:
                    st.lost = True
            self.errors += 1
            return
        if "id" not in msg or _SEQ not in msg:
            self.errors += 1
            return
        self._handle_frame(msg)

    def _stream_for(self, msg: Dict[str, Any]) -> Optional[ClientStream]:
        sid = msg["id"]
        st = self._by_id.get(sid)
        if st is not None:
            return st
        tag = msg.get("tag")
        if tag is not None and tag in self.streams:
            st = self.streams[tag]
            if st.id is not None and st.id != sid:
                # a re-sent submit raced its original across a reconnect
                # and BOTH were accepted: the first acceptance is the one
                # we have been assembling — the newcomer is an orphan
                # whose frames must not fold into this stream
                self._orphans.add(sid)
                return None
            st.id = sid
            self._by_id[sid] = st
            return st
        return None

    def _handle_frame(self, msg: Dict[str, Any]) -> None:
        st = self._stream_for(msg)
        if st is None:
            if msg["id"] in self._orphans:
                return  # superseded duplicate stream: dropped silently
            self.errors += 1  # frame for a stream we never submitted
            return
        seq = int(msg[_SEQ])
        if seq <= st.have_seq:
            st.dups += 1      # replay overlap: dropped, never re-applied
            return
        if seq > st.have_seq + 1:
            st.gaps += 1      # lost frames: the stream is not trustworthy
            st.lost = True
            return
        st.have_seq = seq
        st.tokens.extend(int(t) for t in msg.get("tokens", ()))
        if "priority" in msg:
            st.priority = int(msg["priority"])
        if msg.get("done"):
            st.done = True
            st.status = str(msg.get("status", ""))
            st.n_tokens = int(msg.get("n_tokens", len(st.tokens)))
            # the terminal n_tokens is authoritative: a FAILED stream
            # may retract a streamed suffix (NaN-dropped token)
            del st.tokens[st.n_tokens:]
            st.browned = bool(msg.get("browned", False))
            if "retry_after_s" in msg:
                st.retry_after_s = float(msg["retry_after_s"])
            if "error" in msg:
                st.error = str(msg["error"])
            self._maybe_backoff(st)

    def _maybe_backoff(self, st: ClientStream) -> None:
        if st.status not in ("REJECTED", "SHED"):
            return
        tag = st.tag
        if self._retries_left.get(tag, 0) <= 0:
            return
        self._retries_left[tag] -= 1
        wait = st.retry_after_s if st.retry_after_s is not None else 0.0
        self._retry_at[tag] = self.clock() + wait
        if st.id is not None:
            self._by_id.pop(st.id, None)

    # ---------------- results ----------------

    def results(self) -> Dict[int, List[int]]:
        """Assembled token list per SERVER id for every clean terminal
        stream (lost/gapped streams excluded — they are the evidence,
        not the result)."""
        return {st.id: list(st.tokens) for st in self.streams.values()
                if st.done and not st.lost and st.id is not None}

    def dup_total(self) -> int:
        return sum(st.dups for st in self.streams.values())

    def gap_total(self) -> int:
        return sum(st.gaps for st in self.streams.values())

    def close(self) -> None:
        self.disconnect()
