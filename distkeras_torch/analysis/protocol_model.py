"""Wire-protocol model checker (pass 6 of ``distkeras-torch-lint``).

The PS wire protocol is a set of client<->hub action sequences that PR
12's parity pass only checks for *existence* (every byte handled
somewhere).  This pass adds a declared **transition model** and checks
it two ways:

1. **Static cross-check** against the Python hub's dispatch
   (``SocketParameterServer._handle_connection``):

   - an action byte the hub *admits* (compares against ``action``) that
     the model does not declare is *admitted-but-unmodeled* — the model
     is the contract, so undeclared arms are protocol drift;
   - a modeled request the hub does not admit is
     *modeled-but-unhandled* — a client following the contract would
     desync the stream;
   - a modeled reply the handler provably never produces (neither the
     ``ACTION_*`` constant nor its known encoder appears in the handler
     body) is *modeled-but-unproduced*;
   - model keys must be registered ``ACTION_*`` names (a typo'd key can
     never match and would silently weaken the contract).

2. **Bounded exhaustive exploration** of 2-client x hub interleavings
   (:func:`explore_sessions`): every interleaving of every bounded
   action script, with pipelining up to ``max_inflight``, checking

   - **desync**: a reply kind that does not match the oldest
     outstanding request's declared reply;
   - **deadlock**: a reachable non-final state with no enabled event;

   and of the standby/promotion state machine
   (:func:`explore_standby`): sync-then-delta ``R`` feed, feed loss,
   retry budget, commit-triggered promotion — checking that promotion
   is **reachable**, that no commit is ever acked by an unpromoted
   standby, and that the machine cannot deadlock.

The model is data (:data:`REQUESTS`, :data:`STANDBY_RULES`) so fixture
tests can seed violations; the shipped tables are the contract the real
hubs are checked against.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis.core import (Finding, SourceFile,
                                           apply_annotations, load_sources,
                                           python_files, rel, repo_root)
from distkeras_torch.analysis.wire_parity import parse_action_registry

SELF_PATH = "distkeras_torch/analysis/protocol_model.py"

#: The declared protocol: client-initiated action -> the reply kind the
#: client must receive (None = no reply, connection closes).  ``R`` is
#: the replica hello: the hub replies with an ``R`` sync frame and the
#: connection leaves the request/reply regime (handoff to the feed).
REQUESTS: Dict[str, Optional[str]] = {
    "ACTION_TRACE": "ACTION_TRACE",
    "ACTION_PULL": "ACTION_WEIGHTS",
    "ACTION_SPARSE_PULL": "ACTION_SPARSE_WEIGHTS",
    "ACTION_COMMIT": "ACTION_ACK",
    "ACTION_QCOMMIT": "ACTION_ACK",
    "ACTION_SPARSE_COMMIT": "ACTION_ACK",
    "ACTION_SPARSE_QCOMMIT": "ACTION_ACK",
    "ACTION_HEALTH": "ACTION_ACK",
    "ACTION_PING": "ACTION_ACK",
    "ACTION_RECONNECT": "ACTION_RETRY",
    "ACTION_BYE": None,
    "ACTION_REPL": "ACTION_REPL",
    # shm attach: the client's Z request; the hub replies Z
    # with the ring paths (or an empty decline).  The full three-step
    # never-torn handshake lives in :data:`SHM_RULES`/:func:`explore_shm`
    "ACTION_SHM": "ACTION_SHM",
}

#: Actions that advance the hub's commit clock when served.
CLOCK_BUMPERS: FrozenSet[str] = frozenset({
    "ACTION_COMMIT", "ACTION_QCOMMIT",
    "ACTION_SPARSE_COMMIT", "ACTION_SPARSE_QCOMMIT"})

#: How the handler source proves it PRODUCES each reply kind: any of the
#: listed tokens (an ``ACTION_*`` constant reference, an encoder helper,
#: the feed class that owns the ``R`` stream) appearing in the handler
#: body counts.
REPLY_PRODUCERS: Dict[str, Tuple[str, ...]] = {
    "ACTION_WEIGHTS": ("ACTION_WEIGHTS",),
    "ACTION_ACK": ("ACTION_ACK",),
    "ACTION_SPARSE_WEIGHTS": ("ACTION_SPARSE_WEIGHTS",),
    # the T reply is the clock-sync timestamp, or (for a job-scoped
    # announce) the admission verdict — either encoder in the
    # handler body proves production
    "ACTION_TRACE": ("encode_time_payload", "encode_admission_payload"),
    "ACTION_RETRY": ("encode_retry_payload",),
    "ACTION_REPL": ("ReplicationFeed", "attach"),
    "ACTION_SHM": ("ACTION_SHM",),
}

#: The standby/promotion contract (the failover semantics) as checkable
#: flags — fixture tests flip these to seed violations.
STANDBY_RULES: Dict[str, Any] = {
    # a full R sync is what arms the standby with real job state
    "sync_sets_synced": True,
    # a commit landing while the feed is DOWN (primary presumed dead)
    # promotes the standby before the commit is applied/acked
    "commit_promotes": True,
    # a commit while the feed is still UP is refused and severs the feed
    # as a liveness probe (split-brain guard)
    "commit_probe_severs": True,
    # a never-synced standby must never promote (it holds seed weights)
    "never_synced_promotes": False,
    # feed-loss retries exhausted on a synced standby promote it
    "loss_exhaustion_promotes": True,
    # an ack may only leave a standby AFTER promotion
    "ack_requires_promoted": True,
    # a REPL_SPARSE row-delta frame may only be sent to a standby whose
    # hello announced REPL_CAP_SPARSE (attach-time capability);
    # a legacy standby keeps receiving the dense-materialized delta
    # stream — never a frame kind it cannot parse (a torn stream)
    "sparse_delta_requires_cap": True,
}

#: The fleet join/drain/admission contract as checkable
#: flags.  A job-scoped session announces its namespace on the existing
#: ``T`` trace frame (``job_ns`` key); the hub's admission verdict rides
#: the ``T`` reply.  Planned preemption is SIGTERM-with-a-deadline: the
#: worker finishes its in-flight commits, flushes residuals, sends
#: ``B``, and only then does the controller detach it — membership
#: churn is exactly where interleaving bugs live, so the machine is
#: model-checked before (and independent of) the code.  Fixture tests
#: flip these to seed drain-while-commit-in-flight and
#: admission-reject-races-attach violations.
FLEET_RULES: Dict[str, Any] = {
    # the hub decides admission on the T announce, BEFORE serving any
    # pull/commit on that connection — a verdict raced by an attach
    # would let a to-be-rejected job observe (or move) center state
    "admission_before_attach": True,
    # a rejected connection is never served: any subsequent pull or
    # commit is refused with a protocol error, not silently applied
    "reject_never_serves": True,
    # a draining worker sends BYE only after every in-flight commit is
    # acked (and the int8 residual flush commit, if any, is one of
    # them) — zero acked-commit loss across the drain
    "drain_completes_inflight": True,
    # a respawned replacement pulls the CURRENT center before its first
    # commit — it must never commit a delta computed against the
    # weights its predecessor died holding
    "respawn_pulls_current_center": True,
    # the controller detaches (membership-shrinks) a worker only after
    # observing its drain complete — never mid-commit
    "retire_after_drain_only": True,
}


#: The shm attach/decline/detach contract as checkable flags.
#: The handshake is three TCP frames — client ``Z`` request, hub ``Z``
#: reply (ring paths, or an empty decline), client ``Z`` confirm
#: (mapped / abort) — and only after a positive confirm does EITHER end
#: leave the socket for the ring.  Because TCP is FIFO and the client
#: sends nothing on the socket after a positive confirm, the switch
#: point is totally ordered on both ends: there is never a frame in
#: flight on the transport the peer is not reading.  Fixture tests flip
#: these to seed torn-attach / dead-ring-peer violations.
SHM_RULES: Dict[str, Any] = {
    # the hub's Z reply (offer or decline) travels on the SOCKET — a hub
    # that jumps to the ring before replying strands the client, which
    # is still parked in recv() on TCP
    "reply_before_switch": True,
    # the hub switches to the ring only after the client's positive
    # confirm frame — an offer the client failed to mmap must leave the
    # hub serving TCP
    "switch_requires_confirm": True,
    # a declined attach (hub not shm-capable / no shm_dir) leaves both
    # ends on TCP, byte-identical to a legacy session
    "decline_keeps_tcp": True,
    # a client-side mmap failure aborts the attach (confirm=0); both
    # ends stay on TCP
    "abort_keeps_tcp": True,
    # a legacy hub drops the connection on the unknown Z byte; the
    # client treats that exactly like a decline and redials plain TCP
    "legacy_close_is_decline": True,
    # closing/severing either attached end marks BOTH rings closed so a
    # peer parked in the busy-then-wait read loop wakes and errors out
    # instead of spinning against a dead producer forever
    "sever_wakes_ring_peer": True,
}


# -- static cross-check --------------------------------------------------------

def _handler_fn(ps_src: SourceFile,
                name: str = "_handle_connection") -> Optional[ast.FunctionDef]:
    for node in ast.walk(ps_src.tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def admitted_actions(ps_src: SourceFile) -> Dict[str, int]:
    """``ACTION_*`` names the Python hub's dispatch compares the incoming
    action byte against (``action == net.ACTION_X`` / ``action in
    (...)``), with the comparison line."""
    out: Dict[str, int] = {}
    fn = _handler_fn(ps_src)
    if fn is None:
        return out
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        names = [n for n in ast.walk(node.left)
                 if isinstance(n, ast.Name)]
        if not any(n.id == "action" for n in names):
            continue
        for comp in node.comparators:
            for sub in ast.walk(comp):
                if isinstance(sub, ast.Attribute) \
                        and sub.attr.startswith("ACTION_"):
                    out.setdefault(sub.attr, sub.lineno)
                elif isinstance(sub, ast.Name) \
                        and sub.id.startswith("ACTION_"):
                    out.setdefault(sub.id, sub.lineno)
    return out


def handler_mentions(ps_src: SourceFile) -> Set[str]:
    """Every name/attribute token in the handler body — the vocabulary
    the reply-production check matches producers against."""
    fn = _handler_fn(ps_src)
    if fn is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out


def check_model_vs_dispatch(net_src: SourceFile, ps_src: SourceFile,
                            root: str,
                            requests: Optional[Dict[str, Optional[str]]]
                            = None) -> List[Finding]:
    requests = dict(REQUESTS if requests is None else requests)
    findings: List[Finding] = []
    registry = parse_action_registry(net_src)
    admitted = admitted_actions(ps_src)
    mentions = handler_mentions(ps_src)
    ps_rel = rel(ps_src.path, root)
    net_rel = rel(net_src.path, root)

    for name in sorted(requests):
        if name not in registry:
            findings.append(Finding(
                "protocol", SELF_PATH, 1,
                f"model key {name} is not a registered ACTION_* in "
                f"{net_rel} — a typo'd key never matches anything"))
    for name, line in sorted(admitted.items()):
        if name in registry and name not in requests:
            findings.append(Finding(
                "protocol", ps_rel, line,
                f"{name} is admitted by the hub dispatch but not declared "
                f"in protocol_model.REQUESTS — admitted-but-unmodeled "
                f"protocol drift"))
    for name in sorted(requests):
        if name in registry and name not in admitted:
            b, line = registry[name]
            findings.append(Finding(
                "protocol", net_rel, line,
                f"{name} (byte '{b}') is modeled as a client request but "
                f"the Python hub dispatch never admits it — "
                f"modeled-but-unhandled"))
    for name, reply in sorted(requests.items()):
        if reply is None:
            continue
        producers = REPLY_PRODUCERS.get(reply, (reply,))
        if not any(tok in mentions for tok in producers):
            findings.append(Finding(
                "protocol", ps_rel, 1,
                f"model declares reply {reply} for {name} but the handler "
                f"body references none of {sorted(producers)} — "
                f"modeled-but-unproduced"))
    modeled = set(requests) | {r for r in requests.values() if r}
    for name, (b, line) in sorted(registry.items()):
        if name not in modeled:
            findings.append(Finding(
                "protocol", net_rel, line,
                f"registered action {name} (byte '{b}') appears nowhere in "
                f"the protocol model — declare it as a request or reply in "
                f"protocol_model.REQUESTS"))
    return findings


# -- bounded exhaustive exploration: 2 clients x hub ---------------------------

#: the per-client action alphabet the session exploration draws scripts
#: from — the request/reply core (T/G handshakes and the R handoff leave
#: the regime and are covered by the standby model / static checks)
SESSION_ALPHABET = ("ACTION_PULL", "ACTION_COMMIT", "ACTION_HEALTH",
                    "ACTION_PING", "ACTION_BYE")


def explore_sessions(requests: Optional[Dict[str, Optional[str]]] = None,
                     hub_replies: Optional[Dict[str, Optional[str]]] = None,
                     max_sends: int = 3, max_inflight: int = 2,
                     clients: int = 2, clock_cap: int = 6,
                     alphabet: Sequence[str] = SESSION_ALPHABET
                     ) -> List[Finding]:
    """Exhaustively interleave every bounded client script against the
    hub.  ``requests`` is what CLIENTS expect (the model); ``hub_replies``
    is what the hub produces (defaults to the same table — fixtures pass
    a skewed or arm-missing table to seed desync/deadlock).

    Client state: (sends left, expected-reply FIFO, closed).  Events:
    a client sends any alphabet action (pipelined up to ``max_inflight``),
    the hub serves a client's oldest queued request (atomic:
    reply enqueued, clock bumped), a client consumes its oldest reply.
    """
    requests = dict(REQUESTS if requests is None else requests)
    hub = dict(requests if hub_replies is None else hub_replies)
    findings: List[Finding] = []

    # state: (clock, per-client (sends_left, reqq, replyq, expq, closed))
    init_client = (max_sends, (), (), (), False)
    init = (0, tuple(init_client for _ in range(clients)))
    seen = {init}
    frontier: List[Tuple[Any, Tuple[str, ...]]] = [(init, ())]
    while frontier:
        (clock, cls), trace = frontier.pop()
        moved = False
        done = all(c[4] or (c[0] == 0 and not c[1] and not c[2] and not c[3])
                   for c in cls)
        for ci, (left, reqq, replyq, expq, closed) in enumerate(cls):
            # client sends (branch over the whole alphabet)
            if not closed and left > 0 and len(expq) < max_inflight:
                for act in alphabet:
                    if act not in requests:
                        continue
                    exp = requests[act]
                    nc = (left - 1, reqq + (act,), replyq,
                          expq + ((exp,) if exp is not None else ()),
                          closed or act == "ACTION_BYE")
                    _push(seen, frontier, clock, cls, ci, nc,
                          trace + (f"c{ci} sends {act}",))
                moved = True
            # hub serves the oldest queued request
            if reqq:
                act = reqq[0]
                if act in hub:
                    reply = hub[act]
                    nclock = min(clock_cap, clock + 1) \
                        if act in CLOCK_BUMPERS else clock
                    nc = (left, reqq[1:],
                          replyq + ((reply,) if reply is not None else ()),
                          expq, closed)
                    _push(seen, frontier, nclock, cls, ci, nc,
                          trace + (f"hub serves c{ci} {act}",))
                    moved = True
                # an arm the hub lacks: the request sits unserved forever
                # (surfaces below as a deadlock when nothing else moves)
            # client consumes the oldest reply
            if replyq:
                got = replyq[0]
                if not expq:
                    findings.append(_session_finding(
                        f"client {ci} received {got} with no request "
                        f"outstanding", trace))
                    moved = True  # diagnosed, not deadlocked
                    continue
                want = expq[0]
                if got != want:
                    findings.append(_session_finding(
                        f"desync: client {ci} expected {want} for its "
                        f"oldest request but the hub produced {got}",
                        trace + (f"c{ci} recv {got}",)))
                    moved = True  # diagnosed, not deadlocked
                    continue
                nc = (left, reqq, replyq[1:], expq[1:], closed)
                _push(seen, frontier, clock, cls, ci, nc,
                      trace + (f"c{ci} recv {got}",))
                moved = True
        if not moved and not done:
            findings.append(_session_finding(
                "deadlock: no event enabled but clients still have "
                "unserved requests or unmatched replies", trace))
        if len(findings) >= 8:
            break  # enough counterexamples; keep the report readable
    return findings


def _push(seen, frontier, clock, cls, ci, nc, trace) -> None:
    state = (clock, cls[:ci] + (nc,) + cls[ci + 1:])
    if state not in seen:
        seen.add(state)
        frontier.append((state, trace))


def _session_finding(msg: str, trace: Tuple[str, ...]) -> Finding:
    tail = " -> ".join(trace[-6:])
    return Finding("protocol", SELF_PATH, 1,
                   f"{msg} (trace: {tail})")


# -- bounded exploration: standby / promotion ----------------------------------

def explore_standby(rules: Optional[Dict[str, Any]] = None,
                    retries: int = 2, max_commits: int = 3
                    ) -> List[Finding]:
    """Exhaustive walk of the standby lifecycle: R sync-then-delta feed
    (dense AND row-sparse frames, per the standby's attach-time
    capability), feed loss + bounded retries, worker commits racing all
    of it.  Checks promotion reachability, the acked-while-standby
    invariant, the sparse-frame-capability invariant (a legacy standby
    is never sent a REPL_SPARSE frame — the never-a-torn-stream
    rule), and deadlock freedom.  Both capability generations are
    explored."""
    rules = dict(STANDBY_RULES if rules is None else rules)
    findings: List[Finding] = []
    for sparse_cap in (False, True):
        findings.extend(_explore_standby_cap(rules, sparse_cap, retries,
                                             max_commits))
        if len(findings) >= 8:
            break
    return findings


def _explore_standby_cap(rules: Dict[str, Any], sparse_cap: bool,
                         retries: int, max_commits: int) -> List[Finding]:
    findings: List[Finding] = []
    # state: (synced, feed_up, failures, promoted, commits_left);
    # sparse_cap is attach-time immutable, so it parameterizes the walk
    init = (False, True, 0, False, max_commits)
    seen = {init}
    frontier: List[Tuple[Tuple, Tuple[str, ...]]] = [(init, ())]
    promoted_reachable = False
    while frontier:
        state, trace = frontier.pop()
        synced, feed_up, failures, promoted, commits_left = state
        if promoted:
            promoted_reachable = True
        events: List[Tuple[str, Tuple, Optional[bool]]] = []
        if feed_up and not promoted:
            if rules["sync_sets_synced"]:
                events.append(("feed_sync",
                               (True, feed_up, 0, promoted, commits_left),
                               None))
            else:
                events.append(("feed_sync", state, None))
            if synced:
                events.append(("feed_delta", state, None))
                # the primary frames a row-sparse commit REPL_SPARSE only
                # toward capable replicas; with the rule intact the event
                # is simply not enabled for a legacy standby (it receives
                # the densified REPL_DELTA above instead)
                if sparse_cap or not rules["sparse_delta_requires_cap"]:
                    events.append(("feed_sparse_delta", state, None))
            events.append(("feed_loss",
                           (synced, False, failures, promoted, commits_left),
                           None))
        if not feed_up and not promoted:
            if failures <= retries:
                events.append(("feed_retry_fail",
                               (synced, False, failures + 1, promoted,
                                commits_left), None))
            else:
                promote = (synced and rules["loss_exhaustion_promotes"]) \
                    or (not synced and rules["never_synced_promotes"])
                if promote:
                    events.append(("promote_on_loss",
                                   (synced, False, failures, True,
                                    commits_left), None))
                else:
                    # never-synced standby keeps retrying forever (capped
                    # backoff) — model as a self-loop retry
                    events.append(("feed_retry_fail", state, None))
            events.append(("feed_reconnect",
                           (synced, True, failures, promoted, commits_left),
                           None))
        if commits_left > 0:
            if not synced and not promoted:
                events.append(("commit_refused_unsynced", state, False))
            elif promoted:
                events.append(("commit_acked",
                               (synced, feed_up, failures, promoted,
                                commits_left - 1), True))
            elif feed_up and rules["commit_probe_severs"]:
                events.append(("commit_refused_probe",
                               (synced, False, failures, promoted,
                                commits_left), False))
            elif rules["commit_promotes"]:
                events.append(("commit_acked_after_promote",
                               (synced, feed_up, failures, True,
                                commits_left - 1), True))
            else:
                events.append(("commit_acked",
                               (synced, feed_up, failures, promoted,
                                commits_left - 1), True))
        if promoted and commits_left == 0:
            continue  # final: promoted, every commit served
        if not events:
            findings.append(Finding(
                "protocol", SELF_PATH, 1,
                f"standby deadlock: no event enabled in state "
                f"synced={synced} feed_up={feed_up} promoted={promoted} "
                f"(trace: {' -> '.join(trace[-6:])})"))
            continue
        for name, nstate, acked in events:
            if acked and rules["ack_requires_promoted"] and not nstate[3]:
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"acked-commit-while-standby: event {name} acks a "
                    f"commit but the hub is neither primary nor promoted "
                    f"(trace: {' -> '.join(trace[-5:] + (name,))})"))
                continue
            if name == "feed_sparse_delta" and not sparse_cap:
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"sparse-frame-to-legacy-standby: a REPL_SPARSE frame "
                    f"reaches a standby that never announced "
                    f"REPL_CAP_SPARSE — a torn stream on the dense-R "
                    f"fallback path "
                    f"(trace: {' -> '.join(trace[-5:] + (name,))})"))
                continue
            if nstate not in seen:
                seen.add(nstate)
                frontier.append((nstate, trace + (name,)))
        if len(findings) >= 8:
            return findings
    if not promoted_reachable:
        findings.append(Finding(
            "protocol", SELF_PATH, 1,
            "unreachable-promotion: no interleaving of feed "
            "sync/loss/retry and worker commits ever promotes the "
            "standby — failover is impossible under these rules"))
    return findings


# -- bounded exploration: shm attach / decline / detach ------------------------

def explore_shm(rules: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Exhaustive walk of the shm attach handshake across all
    three hub generations — shm-capable, capable-but-declining, and
    legacy (drops the unknown ``Z`` byte) — and both client mmap
    outcomes.  Checks:

    - **torn-attach**: after the handshake settles, a data exchange with
      the two ends on different transports (one writing the ring the
      other never reads, or writing a socket the other abandoned);
    - **stranded-reply**: the hub's offer/decline sent on the ring
      before the client mapped it (the client is parked in TCP recv);
    - **dead-ring-peer**: a severed attached session whose surviving
      end never wakes from the ring park loop;
    - deadlock freedom: every explored path reaches a settled state.
    """
    rules = dict(SHM_RULES if rules is None else rules)
    findings: List[Finding] = []
    for hub_gen in ("capable", "declining", "legacy"):
        findings.extend(_explore_shm_gen(rules, hub_gen))
        if len(findings) >= 8:
            break
    return findings


def _explore_shm_gen(rules: Dict[str, Any], hub_gen: str) -> List[Finding]:
    findings: List[Finding] = []
    # state: (phase, client_tr, hub_tr); transports are "tcp" | "shm";
    # phases walk idle -> requested -> offered -> confirmed -> settled
    # (decline/abort/legacy-close settle early).  hub_gen is immutable
    # per walk, so it parameterizes the exploration like sparse_cap does
    # for the standby machine.
    init = ("idle", "tcp", "tcp")
    seen = {init}
    frontier: List[Tuple[Tuple[str, str, str], Tuple[str, ...]]] = [(init, ())]
    settled_reachable = False
    while frontier:
        state, trace = frontier.pop()
        phase, client_tr, hub_tr = state
        events: List[Tuple[str, Tuple[str, str, str]]] = []
        if phase == "idle":
            events.append(("client_sends_Z", ("requested", client_tr, hub_tr)))
        elif phase == "requested":
            if hub_gen == "capable":
                # a hub violating reply_before_switch moves to the ring
                # BEFORE its offer frame leaves — the offer then travels
                # on a ring the client has not mapped
                offer_hub_tr = hub_tr if rules["reply_before_switch"] else "shm"
                if offer_hub_tr == "shm" and client_tr == "tcp":
                    findings.append(Finding(
                        "protocol", SELF_PATH, 1,
                        f"stranded-reply: the hub's Z offer is sent on the "
                        f"ring before the client mapped it — the client is "
                        f"parked in TCP recv forever "
                        f"(trace: {' -> '.join(trace + ('hub_offers',))})"))
                else:
                    # a hub violating switch_requires_confirm flips to
                    # the ring at offer time instead of waiting for the
                    # client's mapped-confirm
                    post = offer_hub_tr if rules["switch_requires_confirm"] \
                        else "shm"
                    events.append(("hub_offers", ("offered", client_tr, post)))
            elif hub_gen == "declining":
                post = "tcp" if rules["decline_keeps_tcp"] else "shm"
                events.append(("hub_declines", ("settled", client_tr, post)))
            else:  # legacy: unknown action byte -> connection dropped
                if rules["legacy_close_is_decline"]:
                    events.append(("client_redials_tcp",
                                   ("settled", "tcp", "tcp")))
                else:
                    findings.append(Finding(
                        "protocol", SELF_PATH, 1,
                        f"torn-attach: a legacy hub dropped the Z request "
                        f"and the client neither redials nor degrades — "
                        f"the session is dead "
                        f"(trace: {' -> '.join(trace + ('legacy_close',))})"))
        elif phase == "offered":
            # client maps the rings and sends confirm=1, then moves to
            # the ring itself (it sends nothing further on the socket)
            events.append(("client_mmap_ok", ("confirmed", "shm", hub_tr)))
            abort_hub_tr = "tcp" if rules["abort_keeps_tcp"] else "shm"
            events.append(("client_mmap_fail",
                           ("settled", "tcp",
                            abort_hub_tr if rules["switch_requires_confirm"]
                            else hub_tr)))
        elif phase == "confirmed":
            # the hub consumes the confirm frame (FIFO: it is the last
            # TCP frame this client ever sends) and switches
            post = "shm" if rules["switch_requires_confirm"] else hub_tr
            events.append(("hub_receives_confirm", ("settled", client_tr,
                                                    post)))
        elif phase == "settled":
            settled_reachable = True
            if client_tr != hub_tr:
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"torn-attach: handshake settled with client on "
                    f"{client_tr} and hub on {hub_tr} — every subsequent "
                    f"frame is written to a transport the peer never reads "
                    f"(trace: {' -> '.join(trace)})"))
                continue
            if client_tr == "shm":
                # detach: either end severs; the ring closed flags must
                # wake the surviving end's park loop
                if not rules["sever_wakes_ring_peer"]:
                    findings.append(Finding(
                        "protocol", SELF_PATH, 1,
                        f"dead-ring-peer: an attached end died but the "
                        f"surviving peer's ring park loop is never woken "
                        f"(no closed-flag publication) "
                        f"(trace: {' -> '.join(trace + ('peer_severs',))})"))
            continue  # settled states are final
        if not events and phase != "settled" and not findings:
            findings.append(Finding(
                "protocol", SELF_PATH, 1,
                f"shm-attach deadlock: no event enabled in phase {phase} "
                f"under hub generation {hub_gen} "
                f"(trace: {' -> '.join(trace[-6:])})"))
        for name, nstate in events:
            if nstate not in seen:
                seen.add(nstate)
                frontier.append((nstate, trace + (name,)))
        if len(findings) >= 8:
            return findings
    if not settled_reachable and not findings:
        findings.append(Finding(
            "protocol", SELF_PATH, 1,
            f"shm-attach unreachable-settle: no interleaving under hub "
            f"generation {hub_gen} ever settles the handshake"))
    return findings


# -- bounded exploration: fleet join / drain / admission -----------------------

def explore_fleet(rules: Optional[Dict[str, Any]] = None,
                  max_commits: int = 2) -> List[Finding]:
    """Exhaustive walk of one job-scoped session's lifecycle against the
    hub + controller: T announce -> admission verdict ->
    attach -> pipelined commits -> preemption notice -> drain -> BYE ->
    detach, plus the respawned-replacement generation.  Checks:

    - **admission-races-attach**: a pull/commit served before the
      admission verdict settles;
    - **post-reject-served**: a rejected session later served;
    - **acked-commit-loss**: BYE leaves the worker while commits are
      still in flight — the drain discards work the client believes
      (or will believe) acked;
    - **retire-before-drain**: the controller detaches a worker whose
      drain has not completed;
    - **respawn-blind-commit**: a respawned replacement commits before
      pulling the current center;
    - deadlock freedom: every explored path reaches a final state.

    Both generations (fresh join, post-preemption respawn) are explored;
    the respawn generation differs only in that its blind-commit
    temptation is real (it holds its predecessor's stale weights).
    """
    rules = dict(FLEET_RULES if rules is None else rules)
    findings: List[Finding] = []
    for respawn in (False, True):
        findings.extend(_explore_fleet_gen(rules, respawn, max_commits))
        if len(findings) >= 8:
            break
    return findings


def _explore_fleet_gen(rules: Dict[str, Any], respawn: bool,
                       max_commits: int) -> List[Finding]:
    findings: List[Finding] = []
    # state: (phase, inflight, pulled, commits_left, draining);
    # phases walk announced -> {admitted, rejected}; admitted ->
    # active -> (drain) -> detached; rejected -> closed.  ``respawn``
    # is immutable per walk (it parameterizes the generation the same
    # way sparse_cap does for the standby machine).
    init = ("announced", 0, False, max_commits, False)
    seen = {init}
    frontier: List[Tuple[Tuple, Tuple[str, ...]]] = [(init, ())]
    detached_reachable = False
    while frontier:
        state, trace = frontier.pop()
        phase, inflight, pulled, commits_left, draining = state
        events: List[Tuple[str, Tuple]] = []
        if phase == "announced":
            events.append(("hub_admits",
                           ("admitted", inflight, pulled, commits_left,
                            draining)))
            events.append(("hub_rejects",
                           ("rejected", inflight, pulled, commits_left,
                            draining)))
            if not rules["admission_before_attach"]:
                # a hub that attaches before the verdict settles serves
                # a pull against a center the job may be refused
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"admission-races-attach: a pull is served while the "
                    f"admission verdict is still pending — a "
                    f"to-be-rejected job observed center state "
                    f"(trace: {' -> '.join(trace + ('serve_before_verdict',))})"))
        elif phase == "rejected":
            if rules["reject_never_serves"]:
                events.append(("reject_refused_close",
                               ("closed", 0, pulled, 0, draining)))
            else:
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"post-reject-served: a commit from a REJECTED session "
                    f"is applied to the center — admission control is "
                    f"advisory only "
                    f"(trace: {' -> '.join(trace + ('serve_after_reject',))})"))
        elif phase == "admitted":
            events.append(("first_pull",
                           ("active", inflight, True, commits_left,
                            draining)))
            if respawn and not rules["respawn_pulls_current_center"]:
                findings.append(Finding(
                    "protocol", SELF_PATH, 1,
                    f"respawn-blind-commit: a respawned replacement "
                    f"commits a delta computed against its predecessor's "
                    f"stale weights — it must pull the current center "
                    f"first "
                    f"(trace: {' -> '.join(trace + ('commit_blind',))})"))
        elif phase == "active":
            if commits_left > 0 and inflight < 2 and not draining:
                events.append(("commit_sent",
                               ("active", inflight + 1, pulled,
                                commits_left - 1, draining)))
            if inflight > 0:
                events.append(("commit_acked",
                               ("active", inflight - 1, pulled,
                                commits_left, draining)))
            if not draining:
                events.append(("preemption_notice",
                               ("active", inflight, pulled, commits_left,
                                True)))
            if draining:
                if inflight == 0 or not rules["drain_completes_inflight"]:
                    if inflight > 0:
                        findings.append(Finding(
                            "protocol", SELF_PATH, 1,
                            f"acked-commit-loss: BYE leaves the worker "
                            f"with {inflight} commit(s) still in flight — "
                            f"the drain discards work the hub may ack "
                            f"into a torn session "
                            f"(trace: "
                            f"{' -> '.join(trace + ('bye_with_inflight',))})"))
                    else:
                        events.append(("drained_bye",
                                       ("detached", 0, pulled, 0, True)))
                if not rules["retire_after_drain_only"] and inflight > 0:
                    findings.append(Finding(
                        "protocol", SELF_PATH, 1,
                        f"retire-before-drain: the controller detaches a "
                        f"worker whose in-flight commit was never acked — "
                        f"membership shrinks mid-commit "
                        f"(trace: "
                        f"{' -> '.join(trace + ('force_detach',))})"))
        elif phase in ("detached", "closed"):
            detached_reachable = True
            continue  # final
        if not events and phase not in ("detached", "closed") \
                and not findings:
            findings.append(Finding(
                "protocol", SELF_PATH, 1,
                f"fleet deadlock: no event enabled in phase {phase} "
                f"(inflight={inflight}, draining={draining}) "
                f"(trace: {' -> '.join(trace[-6:])})"))
        for name, nstate in events:
            if nstate not in seen:
                seen.add(nstate)
                frontier.append((nstate, trace + (name,)))
        if len(findings) >= 8:
            return findings
    if not detached_reachable and not findings:
        findings.append(Finding(
            "protocol", SELF_PATH, 1,
            f"fleet unreachable-detach: no interleaving (respawn="
            f"{respawn}) ever completes the join/drain lifecycle"))
    return findings


# -- the pass ------------------------------------------------------------------

def check(net_src: SourceFile, ps_src: SourceFile, root: str,
          sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    findings = check_model_vs_dispatch(net_src, ps_src, root)
    # the exhaustive explorations are cheap (bounded, memoized) and run
    # in the static gate — a model edit that desyncs or deadlocks fails
    # the same run that introduced it
    findings.extend(explore_sessions())
    findings.extend(explore_standby())
    findings.extend(explore_shm())
    findings.extend(explore_fleet())
    return apply_annotations(findings, sources or {}, root, rule="protocol")


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    net_path = os.path.join(root, "distkeras_torch", "runtime", "networking.py")
    ps_path = os.path.join(root, "distkeras_torch", "runtime",
                           "parameter_server.py")
    if not (os.path.exists(net_path) and os.path.exists(ps_path)):
        return []  # partial checkout; the repo gate runs on the real tree
    if sources is None:
        sources = load_sources(python_files(
            root, (os.path.join("distkeras_torch", "runtime"),)))
    net_src = sources.get(net_path) or SourceFile(net_path)
    ps_src = sources.get(ps_path) or SourceFile(ps_path)
    return check(net_src, ps_src, root, sources)
