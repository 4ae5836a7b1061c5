"""Bounded interleaving checker for the registry's concurrency protocol.

This is the third leg of agnolint: an executable model of the
publish/take/release/rollback/sweep state machine from
``repro_torch.core.registry``, explored exhaustively over 2-3 process
schedules with SIGKILL injected at **every** step.  The lint passes
check that the code follows the locking discipline; this module checks
that the discipline itself — at the granularity of individual shm
stores — upholds the registry docstring's convergence invariants.

The model is per-topic, with **per-publisher rings** exactly like
``TOPIC_DT`` (``pub_next_seq``/``pub_waiters`` are per-``pidx`` arrays;
``_fold_releases`` folds one ring).  That matters: a publisher's
transaction journals the whole *topic* row, so its rollback touches
every other ring's ``next_seq`` and — without the OR-merge of the
single-writer columns — would wipe a *different* publisher's
concurrently-armed waiter flag.

This is the port's copy of ``repro/analysis/model.py``.  It models the
port's fold, not the reference's: ``repro_torch/core/registry.py:
_fold_releases`` reads the release bytes, clears their held bits and then
zeroes only the bytes it read, so a lock-free release byte stored between
the read and the zeroing survives for the next fold.  The reference's
``_fold_releases`` zeroes every byte; its model folds in one atomic step
and cannot tell the two apart.  Here the fold is two steps, a lock-free
``f_store`` can land between them, and the ``fold_zeroes_all`` bug puts
the reference's zeroing back: the ``fold_race`` scenario then loses that
release (invariant C).

Correspondence to the real code (one model step per shm store or
lock-transition, in the real order):

====================  =====================================================
model step            registry.py source
====================  =====================================================
``acquire``           ``_topic_flock`` (blocks while held; the kernel
                      releases a dead holder's flock, modeled by ``kill``)
``r_imgs``            ``_recover`` image restore: topic img with the
                      lock-free single-writer columns preserved
                      (``pub_waiters`` OR-merge / lease max), entry img
                      with the ``released`` OR-merge
``r_clean``           ``_recover``'s ``j["state"] = _J_CLEAN`` (a kill
                      between ``r_imgs`` and ``r_clean`` forces the next
                      acquirer to re-apply the restore — rollback
                      idempotence is what makes that safe)
``r_parity``          ``_recover``'s trailing odd-``wseq`` repair
``wodd``/``weven``    ``_locked(write=True)`` seqlock counter bumps
``fold_read``         ``_fold_releases(tidx, pidx)``'s read: one ring's
                      ``seen = released != 0; held &= ~seen`` (a ring
                      with no byte set returns here)
``fold_zero``         ``_fold_releases``'s ``released[seen] = 0``: only
                      the bytes the read saw
``chk``               publish occupancy check: held -> AgnocastQueueFull,
                      unreceived-only -> QoS drop, else quick free
``d_begin/apply/\
clean``               the journaled drop txn (``pub_drops``/state=FREE)
``t_begin``           ``_Txn.__enter__`` — images first, PENDING last
``e_fields``          the entry field stores while state is still FREE
``e_commit``          ``e["state"] = ST_USED``
``t_seq``             ``t["pub_next_seq"][pidx] = seq + 1``
``t_clean``           ``_Txn.__exit__`` success path
``sel/held_/unrec``   take's three claim stores, in take's store order
``f_gate``            release fast-path gate (journal clean, waiter clear)
``f_store``           the single lock-free ``released[sidx] = 1`` byte
``f_recheck``         the Dekker re-check after the byte store
``l_*``               release's locked path (``l_fold_read`` and
                      ``l_fold_zero``, the fold's two steps as above; the
                      journaled held clear)
``notify``            ``_notify_owner`` FIFO write, outside the lock
``arm/wchk``          ``set_pub_waiter(True)`` + the ``can_publish``
                      re-check (reads held *minus* released bytes)
====================  =====================================================

Invariants asserted on every terminal state (after a janitor
convergence pass = ``_recover`` + dead-subscriber sweep):

* **A  quiescence** — journal CLEAN, seqlock parity even, lock free.
* **B  no double-take** — no subscriber ever claims the same
  ``(sidx, ring, seq)`` twice (checked inline during exploration).
* **C  no lost release** — every release the protocol reported complete
  is reflected in the entry's effective held mask.
* **D  no lost wakeup** — a parked waiter whose ring slot is
  effectively free has a FIFO token waiting, and its ``pub_waiters``
  flag was never wiped by someone else's rollback.
* **E  rollback idempotence** — applying a pending dead writer's
  before-image twice equals applying it once (this is what licenses the
  kill window between ``r_imgs`` and ``r_clean``).

Known (documented) exemption for D: a releaser SIGKILLed *after* the
held->0 transition it performed under the lock (its ``_fold_releases``
or its journaled held-bit clear) but *before* the out-of-lock FIFO
write dies with the wakeup token in hand; the janitor sweep cannot see
it (the dead process holds no bits).  The model exempts exactly that
window (``freed_pending`` without ``notified``) and nothing else.

Bug-injection flags (non-vacuity: each must make the checker fail,
proving it can actually see the bugs it claims to guard against):

* ``fold_zeroes_all`` — the zero step clears every release byte of the
  ring, as ``repro/core/registry.py:_fold_releases`` does: a sibling's
  fast-path byte stored between the read and the zeroing is lost, and its
  held bit never clears (invariant C on ``fold_race``, zero kills needed).

* ``no_dekker_recheck`` — drop the fast-path re-check after the release
  byte store: a waiter arming between the gate and the store loses its
  wakeup (invariant D, zero kills needed).
* ``rollback_clobbers_waiters`` — restore the topic image verbatim,
  wiping a concurrently-armed ``pub_waiters`` flag (invariant D via the
  ``waiter-flag-lost`` check; needs one mid-transaction kill).  This is
  a real registry bug that both registries fix — the model reproduces it
  schedule-for-schedule.

Run ``python -m repro_torch.analysis.model --profile fast`` (CI) or
``--profile full`` for the 3-mutator / 2-kill sweep.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["Violation", "explore", "run_profile", "SCENARIOS", "PROFILES",
           "BUGS"]

BLOCK = object()            # step not enabled in this state (lock held)

BUGS = ("no_dekker_recheck", "rollback_clobbers_waiters", "fold_zeroes_all")


class Violation(Exception):
    """An invariant failed; carries the schedule that reached it."""

    def __init__(self, kind: str, detail: str = "", trace=()):
        self.kind, self.detail, self.trace = kind, detail, tuple(trace)
        super().__init__(f"{kind}: {detail}" if detail else kind)

    def schedule(self) -> str:
        return " -> ".join(self.trace)


# -- state ---------------------------------------------------------------------

def _entry():
    return {"seq": -1, "state": "F", "unrec": set(), "held": set(),
            "rel": set()}


def _freeze_entry(e):
    return (e["seq"], e["state"], frozenset(e["unrec"]),
            frozenset(e["held"]), frozenset(e["rel"]))


def _copy_entry(e):
    return {"seq": e["seq"], "state": e["state"], "unrec": set(e["unrec"]),
            "held": set(e["held"]), "rel": set(e["rel"])}


def _thaw_entry(f):
    seq, state, unrec, held, rel = f
    return {"seq": seq, "state": state, "unrec": set(unrec),
            "held": set(held), "rel": set(rel)}


def _init_state(pids, depths):
    return {
        "lock": 0, "parity": False,
        "j": {"state": "C", "pid": 0, "has_topic": False, "has_entry": False,
              "ring": 0, "slot": 0, "t_img": ((0,) * len(depths), False),
              "e_img": _freeze_entry(_entry())},
        # one ring per publisher index, like TOPIC_DT's per-pub arrays
        "rings": [{"next": 0, "entries": [_entry() for _ in range(d)]}
                  for d in depths],
        "waiter": False, "fifo": 0,
        "alive": set(pids), "kills": 0,
        "claims": {}, "rel_done": set(),
        "regs": {p: {} for p in pids},
        "pc": {p: 0 for p in pids},
        "done": {p: False for p in pids},
    }


def _copy(st):
    return {
        "lock": st["lock"], "parity": st["parity"],
        "j": dict(st["j"]),
        "rings": [{"next": r["next"],
                   "entries": [_copy_entry(e) for e in r["entries"]]}
                  for r in st["rings"]],
        "waiter": st["waiter"], "fifo": st["fifo"],
        "alive": set(st["alive"]), "kills": st["kills"],
        "claims": dict(st["claims"]), "rel_done": set(st["rel_done"]),
        "regs": {p: dict(r) for p, r in st["regs"].items()},
        "pc": dict(st["pc"]), "done": dict(st["done"]),
    }


def _freeze(st):
    j = st["j"]
    return (
        st["lock"], st["parity"],
        (j["state"], j["pid"], j["has_topic"], j["has_entry"], j["ring"],
         j["slot"], j["t_img"], j["e_img"]),
        tuple((r["next"], tuple(_freeze_entry(e) for e in r["entries"]))
              for r in st["rings"]),
        st["waiter"], st["fifo"],
        frozenset(st["alive"]), st["kills"],
        frozenset(st["claims"].items()), frozenset(st["rel_done"]),
        tuple((p, tuple(sorted(st["regs"][p].items())))
              for p in sorted(st["regs"])),
        tuple(sorted(st["pc"].items())),
        tuple(sorted(st["done"].items())),
    )


# -- shared protocol fragments -------------------------------------------------

def _j_begin(st, pid, ring, slot, *, topic, entry):
    # images first, PENDING last: mirrors _Txn.__enter__'s store fence —
    # a kill before the PENDING store means no restore (images unused)
    j = st["j"]
    j["pid"], j["ring"], j["slot"] = pid, ring, slot
    j["has_topic"], j["has_entry"] = topic, entry
    if topic:
        # the topic row holds EVERY ring's next_seq and the waiter flag
        j["t_img"] = (tuple(r["next"] for r in st["rings"]), st["waiter"])
    if entry:
        j["e_img"] = _freeze_entry(st["rings"][ring]["entries"][slot])
    j["state"] = "P"


def _restore_imgs(st, bug):
    """The image-restore half of ``_recover`` (journal left PENDING —
    ``r_clean`` is a separate store, so a kill between the two forces a
    re-apply: idempotence is invariant E)."""
    j = st["j"]
    if j["state"] != "P" or j["pid"] in st["alive"]:
        return
    if j["has_topic"]:
        for r, nxt in zip(st["rings"], j["t_img"][0]):
            r["next"] = nxt
        if bug == "rollback_clobbers_waiters":
            st["waiter"] = j["t_img"][1]        # verbatim restore: the bug
        else:
            # single-writer column preserved: OR-merge, like 'released'
            st["waiter"] = st["waiter"] or j["t_img"][1]
    if j["has_entry"]:
        e = st["rings"][j["ring"]]["entries"][j["slot"]]
        cur_rel = set(e["rel"])
        new = _thaw_entry(j["e_img"])
        new["rel"] |= cur_rel                   # release intent survives
        st["rings"][j["ring"]]["entries"][j["slot"]] = new


def _fold_read(st, ring):
    """The read half of ``_fold_releases(tidx, pidx)``, one publisher's ring
    only: clear the held bits of the release bytes seen, and return which
    bytes those were, ``((slot, subs), ...)``."""
    seen = []
    for i, e in enumerate(st["rings"][ring]["entries"]):
        if e["rel"]:
            e["held"] -= e["rel"]
            seen.append((i, tuple(sorted(e["rel"]))))
    return tuple(seen)


def _fold_zero(st, ring, seen, bug):
    """The zeroing half: only the bytes the read saw, or with
    ``fold_zeroes_all`` every byte of the ring (the reference's fold).  A
    ring whose read saw no byte returns before zeroing, in both."""
    if not seen:
        return
    entries = st["rings"][ring]["entries"]
    if bug == "fold_zeroes_all":
        for e in entries:
            e["rel"].clear()
        return
    for i, subs in seen:
        entries[i]["rel"].difference_update(subs)


def _recover_steps(L, bug):
    def r_imgs(st, rg):
        _restore_imgs(st, bug)

    def r_clean(st, rg):
        j = st["j"]
        if j["state"] == "P" and j["pid"] not in st["alive"]:
            j["state"] = "C"

    def r_parity(st, rg):
        st["parity"] = False
    return [(L + ".r_imgs", r_imgs), (L + ".r_clean", r_clean),
            (L + ".r_parity", r_parity)]


def _acquire(pid, label):
    def acquire(st, rg):
        if st["lock"]:
            return BLOCK
        st["lock"] = pid
    return (label, acquire)


# -- ops -----------------------------------------------------------------------

def op_publish(pid, k, *, ring, subs, bug):
    L = f"P{pid}.pub{k}"

    def wodd(st, rg):
        st["parity"] = True

    def fold_read(st, rg):
        rg["seen"] = _fold_read(st, ring)

    def fold_zero(st, rg):
        _fold_zero(st, ring, rg.pop("seen"), bug)

    def _slot(st):
        r = st["rings"][ring]
        return r, r["entries"][r["next"] % len(r["entries"])]

    def chk(st, rg):
        _, e = _slot(st)
        rg["drop"] = False
        if e["state"] == "U":
            if e["held"]:
                return ("goto", L + ".qf")      # AgnocastQueueFull
            if e["unrec"]:
                rg["drop"] = True               # QoS keep-last drop
            else:
                e["state"] = "F"                # quick free, no journal

    def d_begin(st, rg):
        if rg["drop"]:
            r = st["rings"][ring]
            _j_begin(st, pid, ring, r["next"] % len(r["entries"]),
                     topic=True, entry=True)

    def d_apply(st, rg):
        if rg["drop"]:
            _slot(st)[1]["state"] = "F"

    def d_clean(st, rg):
        if rg["drop"]:
            st["j"]["state"] = "C"

    def t_begin(st, rg):
        r = st["rings"][ring]
        _j_begin(st, pid, ring, r["next"] % len(r["entries"]),
                 topic=True, entry=True)

    def e_fields(st, rg):
        r, e = _slot(st)
        e["seq"] = r["next"]
        e["unrec"] = set(subs)                  # sub_alive mask at publish
        e["held"], e["rel"] = set(), set()

    def e_commit(st, rg):
        _slot(st)[1]["state"] = "U"

    def t_seq(st, rg):
        st["rings"][ring]["next"] += 1

    def t_clean(st, rg):
        st["j"]["state"] = "C"

    def weven(st, rg):
        st["parity"] = False

    def unlock(st, rg):
        st["lock"] = 0
        return ("goto", L + ".end")

    def qf_weven(st, rg):
        st["parity"] = False

    def qf_unlock(st, rg):
        st["lock"] = 0

    def end(st, rg):
        pass

    return ([_acquire(pid, L + ".acquire")] + _recover_steps(L, bug) + [
        (L + ".wodd", wodd), (L + ".fold_read", fold_read),
        (L + ".fold_zero", fold_zero), (L + ".chk", chk),
        (L + ".d_begin", d_begin), (L + ".d_apply", d_apply),
        (L + ".d_clean", d_clean),
        (L + ".t_begin", t_begin), (L + ".e_fields", e_fields),
        (L + ".e_commit", e_commit), (L + ".t_seq", t_seq),
        (L + ".t_clean", t_clean),
        (L + ".weven", weven), (L + ".unlock", unlock),
        (L + ".qf", qf_weven), (L + ".qf_unlock", qf_unlock),
        (L + ".end", end),
    ])


def op_take(pid, k, *, bug):
    L = f"S{pid}.take{k}"

    def wodd(st, rg):
        st["parity"] = True

    def sel(st, rg):
        claim = tuple((ri, i)
                      for ri, r in enumerate(st["rings"])
                      for i, e in enumerate(r["entries"])
                      if e["state"] == "U" and pid in e["unrec"])
        rg["claim"] = claim
        rg["claimed"] = rg.get("claimed", ()) + tuple(
            (ri, st["rings"][ri]["entries"][i]["seq"]) for ri, i in claim)
        for ri, i in claim:
            st["rings"][ri]["entries"][i]["rel"].discard(pid)

    def held_(st, rg):
        for ri, i in rg["claim"]:
            st["rings"][ri]["entries"][i]["held"].add(pid)

    def unrec(st, rg):
        for ri, i in rg["claim"]:
            e = st["rings"][ri]["entries"][i]
            e["unrec"].discard(pid)
            key = (pid, ri, e["seq"])
            st["claims"][key] = st["claims"].get(key, 0) + 1
            if st["claims"][key] > 1:
                raise Violation("double-take",
                                f"sub {pid} claimed ring {ri} seq "
                                f"{e['seq']} twice")

    def weven(st, rg):
        st["parity"] = False

    def unlock(st, rg):
        st["lock"] = 0

    return ([_acquire(pid, L + ".acquire")] + _recover_steps(L, bug) + [
        (L + ".wodd", wodd), (L + ".sel", sel), (L + ".held", held_),
        (L + ".unrec", unrec), (L + ".weven", weven),
        (L + ".unlock", unlock),
    ])


def op_release(pid, k, *, bug):
    L = f"S{pid}.rel{k}"

    def _slot(st, rg):
        ri, q = rg["q"]
        r = st["rings"][ri]
        return r["entries"][q % len(r["entries"])]

    def f_gate(st, rg):
        cl = rg.get("claimed") or ()
        if not cl:
            return ("goto", L + ".end")
        rg["q"] = cl[0]
        if st["j"]["state"] == "P" or st["waiter"]:
            return ("goto", L + ".l_acq")

    def f_store(st, rg):
        e = _slot(st, rg)
        if e["seq"] == rg["q"][1] and e["state"] == "U" and pid in e["held"]:
            e["rel"].add(pid)                   # THE lock-free byte store
        else:
            st["rel_done"].add((pid,) + rg["q"])  # recycled: no-op release
            return ("goto", L + ".end")

    def f_recheck(st, rg):
        if bug == "no_dekker_recheck" or (
                not st["waiter"] and st["j"]["state"] != "P"):
            st["rel_done"].add((pid,) + rg["q"])
            return ("goto", L + ".end")
        # waiter armed / rollback pending: fall through to the locked path

    def wodd(st, rg):
        st["parity"] = True

    def l_fold_read(st, rg):
        e = _slot(st, rg)
        # if this fold performs the target's held->0 transition, WE now
        # owe the owner a wakeup (the documented kill-window exemption
        # covers dying between here and .notify); decided on the EFFECTIVE
        # held mask, before the read, as in the single-step fold
        if e["held"] and not (e["held"] - e["rel"]):
            rg["freed_pending"] = True
        rg["seen"] = _fold_read(st, rg["q"][0])

    def l_fold_zero(st, rg):
        _fold_zero(st, rg["q"][0], rg.pop("seen"), bug)

    def l_chk(st, rg):
        e = _slot(st, rg)
        rg["do"] = e["seq"] == rg["q"][1] and e["state"] == "U"

    def l_begin(st, rg):
        if rg["do"]:
            ri, q = rg["q"]
            _j_begin(st, pid, ri,
                     q % len(st["rings"][ri]["entries"]),
                     topic=False, entry=True)

    def l_store(st, rg):
        if rg["do"]:
            e = _slot(st, rg)
            e["held"].discard(pid)
            e["rel"].discard(pid)
            if not (e["held"] - e["rel"]):
                rg["freed_pending"] = True      # eff held->0: wakeup owed

    def l_clean(st, rg):
        if rg["do"]:
            st["j"]["state"] = "C"
        # EFFECTIVE held, like the fixed registry.release: a sibling's
        # lock-free byte landing after our fold's read still counts
        e = _slot(st, rg)
        rg["freed"] = rg["do"] and not (e["held"] - e["rel"])

    def weven(st, rg):
        st["parity"] = False

    def unlock(st, rg):
        st["lock"] = 0

    def notify(st, rg):
        # outside the lock, like _notify_owner
        st["rel_done"].add((pid,) + rg["q"])
        rg["notified"] = True
        if rg.get("freed") and st["waiter"]:
            st["fifo"] += 1

    def end(st, rg):
        pass

    return [
        (L + ".f_gate", f_gate), (L + ".f_store", f_store),
        (L + ".f_recheck", f_recheck),
        _acquire(pid, L + ".l_acq"),
    ] + _recover_steps(L, bug) + [
        (L + ".wodd", wodd), (L + ".l_fold_read", l_fold_read),
        (L + ".l_fold_zero", l_fold_zero), (L + ".l_chk", l_chk),
        (L + ".l_begin", l_begin), (L + ".l_store", l_store),
        (L + ".l_clean", l_clean), (L + ".weven", weven),
        (L + ".unlock", unlock), (L + ".notify", notify), (L + ".end", end),
    ]


def op_waiter(pid, k, *, ring, bug):
    L = f"W{pid}.wait{k}"

    def arm(st, rg):
        st["waiter"] = True                     # set_pub_waiter: lock-free

    def wchk(st, rg):
        # can_publish re-check AFTER arming; reads held minus released
        r = st["rings"][ring]
        e = r["entries"][r["next"] % len(r["entries"])]
        busy = e["state"] == "U" and (e["held"] - e["rel"])
        if busy:
            rg["parked"] = True                 # blocks on the slot FIFO
        else:
            st["waiter"] = False
            rg["parked"] = False

    return [(L + ".arm", arm), (L + ".wchk", wchk)]


# -- scenarios -----------------------------------------------------------------

class Scenario:
    def __init__(self, name, *, depths, subs, waiter, waiter_ring, programs,
                 kill_set, max_kills, setup=None):
        self.name, self.depths = name, tuple(depths)
        self.subs, self.waiter = tuple(subs), waiter
        self.waiter_ring = waiter_ring
        self.programs = programs                # pid -> list[(op, kwargs)]
        self.kill_set, self.max_kills = tuple(kill_set), max_kills
        self.setup = setup

    def build(self, bug):
        procs = []
        for pid, ops in self.programs.items():
            steps = []
            for k, (op, kw) in enumerate(ops):
                steps += op(pid, k, bug=bug, **kw)
            index = {lab: i for i, (lab, _) in enumerate(steps)}
            procs.append({"pid": pid, "steps": steps, "index": index})
        return procs

    def initial(self):
        st = _init_state(tuple(self.programs), self.depths)
        if self.setup is not None:
            self.setup(st)
        return st


def _prefill_held(st, *, ring, subs):
    """Ring ``ring`` slot 0 already published as seq 0 and claimed by
    ``subs`` — the waiter scenarios start where the interesting race
    begins instead of spending states re-deriving publish+take."""
    r = st["rings"][ring]
    e = r["entries"][0]
    e["seq"], e["state"] = 0, "U"
    e["held"] = set(subs)
    r["next"] = 1
    for s in subs:
        st["claims"][(s, ring, 0)] = 1
        st["regs"][s]["claimed"] = ((ring, 0),)


def _scenarios():
    pub, take, rel, wait = op_publish, op_take, op_release, op_waiter
    return {
        # the 2-process core: publisher vs subscriber, depth-1 ring, one
        # SIGKILL anywhere — QueueFull, QoS drop, rollback, fold, sweep
        "pub_take_release": Scenario(
            "pub_take_release", depths=(1,), subs=(2,), waiter=None,
            waiter_ring=0,
            programs={
                1: [(pub, {"ring": 0, "subs": (2,)}),
                    (pub, {"ring": 0, "subs": (2,)})],
                2: [(take, {}), (rel, {})],
            },
            kill_set=(1, 2), max_kills=1),
        # the wakeup protocol: W owns ring 0 (full, held by S), P
        # publishes on ring 1 of the same topic — P's transaction
        # journals the topic row, so a mid-transaction kill exercises
        # the rollback-vs-lock-free-arm race against W's flag, while
        # S's fast-path release races the arm (Dekker re-check)
        "waiter_wakeup": Scenario(
            "waiter_wakeup", depths=(1, 1), subs=(2,), waiter=3,
            waiter_ring=0,
            programs={
                1: [(pub, {"ring": 1, "subs": (2,)}),
                    (pub, {"ring": 1, "subs": (2,)})],
                2: [(rel, {})],
                3: [(wait, {"ring": 0})],
            },
            kill_set=(1, 2), max_kills=1,
            setup=lambda st: _prefill_held(st, ring=0, subs=(2,))),
        # 3 mutators + waiter, two kills: two subscribers hold W's ring,
        # each releasing concurrently while P churns ring 1
        "two_subs": Scenario(
            "two_subs", depths=(1, 1), subs=(2, 4), waiter=3,
            waiter_ring=0,
            programs={
                1: [(pub, {"ring": 1, "subs": (2, 4)}),
                    (pub, {"ring": 1, "subs": (2, 4)})],
                2: [(rel, {})],
                3: [(wait, {"ring": 0})],
                4: [(rel, {})],
            },
            kill_set=(1, 2, 4), max_kills=2,
            setup=lambda st: _prefill_held(st, ring=0, subs=(2, 4))),
        # the fold's two steps against a lock-free release: two subscribers
        # hold W's ring and release it while W parks on it; no publisher, no
        # kill.  One subscriber's byte lands between the other's locked
        # fold read and its zeroing (the zeroing must keep it)
        "fold_race": Scenario(
            "fold_race", depths=(1,), subs=(2, 4), waiter=3,
            waiter_ring=0,
            programs={
                2: [(rel, {})],
                3: [(wait, {"ring": 0})],
                4: [(rel, {})],
            },
            kill_set=(), max_kills=0,
            setup=lambda st: _prefill_held(st, ring=0, subs=(2, 4))),
    }


SCENARIOS = _scenarios()
PROFILES = {
    "fast": ("pub_take_release", "waiter_wakeup", "fold_race"),
    "full": ("pub_take_release", "waiter_wakeup", "fold_race", "two_subs"),
}


# -- convergence + invariants --------------------------------------------------

def _converge(st, scn, bug):
    """The janitor pass every terminal state gets: _recover, then the
    dead-subscriber sweep (_drop_subscriber + flag-gated owner notify)."""
    _restore_imgs(st, bug)
    j = st["j"]
    if j["state"] == "P" and j["pid"] not in st["alive"]:
        j["state"] = "C"
    st["parity"] = False
    if scn.waiter is not None and scn.waiter not in st["alive"]:
        st["waiter"] = False                    # sweep clears dead pubs' flags
    cleared_held = False
    for r in st["rings"]:
        for e in r["entries"]:
            for s in scn.subs:
                if s not in st["alive"]:
                    if s in e["held"]:
                        cleared_held = True
                    e["unrec"].discard(s)
                    e["held"].discard(s)
                    e["rel"].discard(s)
    if cleared_held and st["waiter"]:
        st["fifo"] += 1                         # _notify_owners after sweep


def _check_terminal(st, scn, bug, trace):
    # E: rollback idempotence on a pending dead writer's journal
    if st["j"]["state"] == "P" and st["j"]["pid"] not in st["alive"]:
        once = _copy(st)
        _restore_imgs(once, bug)
        twice = _copy(once)
        _restore_imgs(twice, bug)
        if _freeze(once) != _freeze(twice):
            raise Violation("rollback-not-idempotent",
                            "applying the before-image twice != once",
                            trace)
    c = _copy(st)
    _converge(c, scn, bug)
    # A: quiescence
    if c["lock"] or c["parity"]:
        raise Violation("not-quiescent",
                        f"lock={c['lock']} parity={c['parity']}", trace)
    if c["j"]["state"] == "P":
        raise Violation("journal-left-pending",
                        f"writer {c['j']['pid']} finished with a pending "
                        "journal", trace)
    # C: no lost release
    for sidx, ri, q in c["rel_done"]:
        r = c["rings"][ri]
        e = r["entries"][q % len(r["entries"])]
        if (e["seq"] == q and e["state"] == "U"
                and sidx in e["held"] and sidx not in e["rel"]):
            raise Violation("lost-release",
                            f"sub {sidx} completed release of ring {ri} "
                            f"seq {q} but still holds it", trace)
    # D: no lost wakeup
    w = scn.waiter
    if w is not None and w in c["alive"] and c["regs"][w].get("parked"):
        if not c["waiter"]:
            raise Violation("waiter-flag-lost",
                            f"waiter {w} is parked but its pub_waiters "
                            "flag was wiped (rollback clobber)", trace)
        r = c["rings"][scn.waiter_ring]
        e = r["entries"][r["next"] % len(r["entries"])]
        free = not (e["state"] == "U" and (e["held"] - e["rel"]))
        exempt = any(
            pid not in c["alive"]
            and c["regs"][pid].get("freed_pending")
            and not c["regs"][pid].get("notified")
            for pid in c["regs"])
        if free and c["fifo"] == 0 and not exempt:
            raise Violation("lost-wakeup",
                            f"waiter {w} parked, slot free, no FIFO token",
                            trace)


# -- explorer ------------------------------------------------------------------

def _trace_to(seen, fkey, extra):
    out = []
    while fkey is not None:
        parent, move = seen[fkey]
        if move is not None:
            out.append(move)
        fkey = parent
    out.reverse()
    out.append(extra)
    return out


def explore(scn: Scenario, *, bug=None, max_states=5_000_000):
    """Exhaustive explicit-state search; raises Violation, returns stats."""
    procs = scn.build(bug)
    by_pid = {p["pid"]: p for p in procs}
    st0 = scn.initial()
    f0 = _freeze(st0)
    seen = {f0: (None, None)}
    stack = [(st0, f0)]
    stats = {"scenario": scn.name, "states": 1, "terminals": 0,
             "transitions": 0}
    while stack:
        st, fkey = stack.pop()
        enabled = 0
        for pid in sorted(by_pid):
            if st["done"][pid] or pid not in st["alive"]:
                continue
            p = by_pid[pid]
            i = st["pc"][pid]
            label, fn = p["steps"][i]
            ns = _copy(st)
            try:
                r = fn(ns, ns["regs"][pid])
            except Violation as v:
                raise Violation(v.kind, v.detail,
                                _trace_to(seen, fkey, label)) from None
            if r is BLOCK:
                continue
            enabled += 1
            if isinstance(r, tuple) and r[0] == "goto":
                ns["pc"][pid] = p["index"][r[1]]
            else:
                ns["pc"][pid] = i + 1
            if ns["pc"][pid] >= len(p["steps"]):
                ns["done"][pid] = True
            nf = _freeze(ns)
            stats["transitions"] += 1
            if nf not in seen:
                seen[nf] = (fkey, label)
                stack.append((ns, nf))
                stats["states"] += 1
                if stats["states"] > max_states:
                    raise RuntimeError(
                        f"{scn.name}: state bound {max_states} exceeded")
        if st["kills"] < scn.max_kills:
            for pid in scn.kill_set:
                if pid not in st["alive"] or st["done"][pid]:
                    continue
                ns = _copy(st)
                ns["alive"].discard(pid)        # SIGKILL: anywhere, anytime
                ns["kills"] += 1
                if ns["lock"] == pid:
                    ns["lock"] = 0              # kernel releases the flock
                nf = _freeze(ns)
                stats["transitions"] += 1
                if nf not in seen:
                    seen[nf] = (fkey, f"kill({pid})")
                    stack.append((ns, nf))
                    stats["states"] += 1
        if not enabled:
            blocked = [p for p in by_pid
                       if p in st["alive"] and not st["done"][p]]
            if blocked:
                raise Violation("deadlock", f"procs {blocked} blocked",
                                _trace_to(seen, fkey, "<stuck>"))
            stats["terminals"] += 1
            _check_terminal(st, scn, bug, _trace_to(seen, fkey, "<terminal>"))
    return stats


def run_profile(profile: str, *, bug=None, max_states=5_000_000):
    out = []
    for name in PROFILES[profile]:
        out.append(explore(SCENARIOS[name], bug=bug, max_states=max_states))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.model",
        description="Bounded interleaving checker for the registry "
                    "concurrency protocol (see module docstring).")
    ap.add_argument("--profile", choices=sorted(PROFILES), default="fast")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    help="run one scenario instead of a profile")
    ap.add_argument("--bug", choices=BUGS,
                    help="inject a known protocol bug; the run MUST fail "
                    "(non-vacuity check)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable stats on stdout")
    args = ap.parse_args(argv)
    names = (args.scenario,) if args.scenario else PROFILES[args.profile]
    results, failed = [], None
    try:
        for name in names:
            results.append(explore(SCENARIOS[name], bug=args.bug))
    except Violation as v:
        failed = v
    if args.json:
        print(json.dumps({
            "ok": failed is None, "bug": args.bug, "results": results,
            "violation": None if failed is None else
            {"kind": failed.kind, "detail": failed.detail,
             "schedule": failed.schedule()},
        }, indent=2))
    elif failed is None:
        for r in results:
            print(f"  {r['scenario']}: {r['states']} states, "
                  f"{r['terminals']} terminals, "
                  f"{r['transitions']} transitions -- all invariants hold")
    if failed is not None:
        if not args.json:
            print(f"VIOLATION [{failed.kind}] {failed.detail}",
                  file=sys.stderr)
            print("schedule: " + failed.schedule(), file=sys.stderr)
        # with an injected bug a violation is the EXPECTED outcome
        return 0 if args.bug else 1
    if args.bug:
        print(f"ERROR: bug {args.bug!r} injected but no violation found "
              "(the checker is vacuous)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
