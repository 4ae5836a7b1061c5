"""The port's static checks (``repro_torch.analysis``) held against the
reference's (``repro.analysis``).

The lint rules on the same fixtures give the same findings, the path-scoped
rules see the port's modules, the port's tree lints clean, its layout lock
equals the reference's section for section and still catches drift, and its
model checker, whose fold is the port's two-step fold, passes every fast
scenario, fails under the reference's two bugs and fails ``fold_race`` with
the reference's zero-all fold.  The two registry regressions of
``tests/test_analysis.py`` run against the port's ``Registry``."""

import json
import os
import subprocess
import sys

import pytest

import repro.analysis.lint as ref_lint
import repro.analysis.model as ref_model
import repro_torch.analysis.model as model
from repro_torch.analysis import check_layout, lint_paths, lint_source
from repro_torch.analysis.layout import (LOCK_PATH, compute_lock, extract_layout,
                                         write_lock)
from repro_torch.core import Registry
from repro_torch.core.registry import _J_PENDING
from test_analysis import (_CNT_BAD, _HOT3_BAD, _LOCK1_BAD, _LOCK1_GOOD, _LOCK2_BAD,
                           _LOCK2_GOOD, _LOCK3_BAD, _dead_pid)
from _port_env import port_test_env  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
REF_LOCK = os.path.join(SRC, "repro", "analysis", "layout_lock.json")


def _rules(report):
    return sorted({f.rule for f in report.findings})


# ---------------------------------------------------------------------------
# lint: the reference's fixtures, same rules on both packages' paths
# ---------------------------------------------------------------------------

_SLEEP = "import time\n\ndef f():\n    time.sleep(1)\n"
_QUEUEFULL = "def f(e):\n    return isinstance(e, AgnocastQueueFull)\n"
_JUSTIFIED = _LOCK1_BAD.replace(
    "self.rows[i] = 7",
    "self.rows[i] = 7  # agnolint: allow[AGNO-LOCK-001] -- "
    "single-writer byte, folded under the next lock holder")
_UNJUSTIFIED = _LOCK1_BAD.replace(
    "self.rows[i] = 7", "self.rows[i] = 7  # agnolint: allow[AGNO-LOCK-001]")
_CNT_GOOD = _CNT_BAD.replace(
    "self.dropped = 0", 'self.dropped = _metrics.counter("bridge.dropped")').replace(
    "self.dropped += 1", "self.dropped.inc()")

# (fixture of tests/test_analysis.py, path under the package, rules it gives)
LINT_FIXTURES = {
    "lock001_unlocked": (_LOCK1_BAD, "core/fake.py", ["AGNO-LOCK-001"]),
    "lock001_locked": (_LOCK1_GOOD, "core/fake.py", []),
    "lock001_readonly": (_LOCK1_GOOD.replace("self._locked(i)", "self._locked(i, write=False)"),
                         "core/fake.py", ["AGNO-LOCK-001"]),
    "lock002_bad": (_LOCK2_BAD, "core/fake.py", ["AGNO-LOCK-002"]),
    "lock002_good": (_LOCK2_GOOD, "core/fake.py", []),
    "lock003_bad": (_LOCK3_BAD, "core/fake.py", ["AGNO-LOCK-003"]),
    "lock003_outside": (_LOCK3_BAD.replace("            time.sleep(0.1)",
                                           "            pass\n        time.sleep(0.1)"),
                        "core/fake.py", []),
    "hot001_topic": (_SLEEP, "core/topic.py", ["AGNO-HOT-001"]),
    "hot001_elsewhere": (_SLEEP, "apps/replay.py", []),
    "hot002_pipeline": (_QUEUEFULL, "data/pipeline.py", ["AGNO-HOT-002"]),
    "hot002_elsewhere": (_QUEUEFULL, "core/fake.py", []),
    "hot003_bad": (_HOT3_BAD, "obs/trace.py", ["AGNO-HOT-003"]),
    "hot003_good": (_HOT3_BAD.replace('        data = {"stage": stage}\n', ""),
                    "obs/trace.py", []),
    "cnt001_bad": (_CNT_BAD, "core/fake.py", ["AGNO-CNT-001"]),
    "cnt001_good": (_CNT_GOOD, "core/fake.py", []),
    "suppression_justified": (_JUSTIFIED, "core/fake.py", []),
    "suppression_unjustified": (_UNJUSTIFIED, "core/fake.py", ["AGNO-SUPP-001"]),
}


@pytest.mark.parametrize("case", sorted(LINT_FIXTURES))
def test_lint_fixture_gives_the_references_rules(case):
    text, rel, want = LINT_FIXTURES[case]
    port = lint_source(text, "repro_torch/" + rel)
    ref = ref_lint.lint_source(text, "repro/" + rel)
    assert _rules(port) == _rules(ref) == want
    assert [(s.rule, s.kind, s.justification) for s in port.suppressions] == \
        [(s.rule, s.kind, s.justification) for s in ref.suppressions]


# every path-scoped rule, on each port module it guards
HOT_PATHS = {
    "core/topic.py": (_SLEEP, "AGNO-HOT-001"),
    "core/routing.py": (_SLEEP, "AGNO-HOT-001"),
    "core/executor.py": (_SLEEP, "AGNO-HOT-001"),
    "data/pipeline.py": (_QUEUEFULL, "AGNO-HOT-002"),
    "data/ordered.py": (_QUEUEFULL, "AGNO-HOT-002"),
    "apps/pointcloud.py": (_QUEUEFULL, "AGNO-HOT-002"),
    "obs/trace.py": (_HOT3_BAD, "AGNO-HOT-003"),
}


@pytest.mark.parametrize("rel", sorted(HOT_PATHS))
def test_hot_rules_see_the_port_paths(rel):
    """A hot-path violation in a port module is a finding for the port's lint
    and none for the reference's, whose suffixes match ``repro/...`` only."""
    text, rule = HOT_PATHS[rel]
    assert _rules(lint_source(text, "repro_torch/" + rel)) == [rule]
    assert ref_lint.lint_source(text, "repro_torch/" + rel).findings == []


def test_port_tree_lints_clean():
    rep = lint_paths([PORT], root=ROOT)
    assert len(rep.files) > 90
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert rep.suppressions and all(s.justification for s in rep.suppressions)


def test_no_sleep_backpressure_on_the_ports_publish_paths():
    """The counterpart of ``tests/test_routing.py``'s hot-path check, over the
    port's publish-path modules."""
    mods = [os.path.join(PORT, *rel.split("/")) for rel in HOT_PATHS]
    rep = lint_paths(mods, root=ROOT)
    assert len(rep.files) == len(HOT_PATHS)
    hot = [f for f in rep.findings if f.rule.startswith("AGNO-HOT")]
    assert hot == [], [str(f) for f in hot]


# ---------------------------------------------------------------------------
# layout: the port's lock is the reference's, and drift is still caught
# ---------------------------------------------------------------------------

def test_port_lock_equals_the_references_lock():
    with open(LOCK_PATH) as fh:
        port = json.load(fh)
    with open(REF_LOCK) as fh:
        ref = json.load(fh)
    assert set(port) == set(ref) == {"registry", "trace", "transport", "metrics"}
    for sec in ref:
        assert port[sec]["version"] == ref[sec]["version"], sec
        assert port[sec]["fingerprint"] == ref[sec]["fingerprint"], sec
    # and the lock is what the port's files give now
    assert compute_lock([SRC]) == port


def test_port_tree_layout_clean():
    assert check_layout([SRC]) == []


def _scratch(tmp_path, rel, transform):
    with open(os.path.join(PORT, *rel.split("/")), encoding="utf-8") as fh:
        text = fh.read()
    new = transform(text)
    assert new != text, "the transform changed nothing"
    out = tmp_path / rel.replace("/", "_")
    out.write_text(new)
    return str(out)


def test_pubhdr_drift_without_a_wire_rev_bump_fails(tmp_path):
    scratch = _scratch(tmp_path, "core/transport.py", lambda t: t.replace(
        '_PUBHDR = struct.Struct("<HBBQQQ")', '_PUBHDR = struct.Struct("<HBBQQQI")', 1))
    findings = check_layout([SRC], overrides={"transport": scratch})
    assert any(f.rule == "AGNO-LAYOUT-001" and "did not" in f.msg and "transport" in f.msg
               for f in findings), [str(f) for f in findings]


def test_pubhdr_drift_with_a_wire_rev_bump_asks_for_a_new_lock(tmp_path):
    def bump(t):
        t = t.replace('_PUBHDR = struct.Struct("<HBBQQQ")',
                      '_PUBHDR = struct.Struct("<HBBQQQI")', 1)
        return t.replace("WIRE_REV = 1", "WIRE_REV = 2", 1)
    scratch = _scratch(tmp_path, "core/transport.py", bump)
    findings = check_layout([SRC], overrides={"transport": scratch})
    assert any(f.rule == "AGNO-LAYOUT-001" and "regenerate" in f.msg for f in findings), \
        [str(f) for f in findings]


def test_registry_drift_without_a_magic_bump_fails(tmp_path):
    scratch = _scratch(tmp_path, "core/registry.py",
                       lambda t: t.replace("MAX_PUBS = 8", "MAX_PUBS = 16", 1))
    findings = check_layout([SRC], overrides={"registry": scratch})
    assert any(f.rule == "AGNO-LAYOUT-001" and "did not" in f.msg for f in findings), \
        [str(f) for f in findings]


def test_layout_lock_roundtrip(tmp_path):
    lock = tmp_path / "lock.json"
    write_lock([SRC], lock_path=str(lock))
    assert check_layout([SRC], lock_path=str(lock)) == []
    with open(LOCK_PATH) as fh:
        assert json.loads(lock.read_text()) == json.load(fh)


def test_layout_extraction_sees_the_ports_constants():
    ext = extract_layout([SRC])
    for sec, d in ext.items():
        assert os.sep + "repro_torch" + os.sep in d["path"], (sec, d["path"])
        assert d["missing"] == [], sec
    reg = ext["registry"]["consts"]
    assert reg["MAX_SUBS"] == 64 and reg["MAX_PUBS"] == 8
    assert ext["trace"]["consts"]["REC_SIZE"] == 24
    assert ext["transport"]["version"] == 1
    assert ext["transport"]["consts"]["_PUBHDR"] == {"__struct__": "<HBBQQQ", "size": 28}


def test_diverged_domain_hash_fails_layout_002(tmp_path):
    scratch = _scratch(tmp_path, "obs/metrics.py",
                       lambda t: t.replace("digest_size=6", "digest_size=8", 1))
    findings = check_layout([SRC], overrides={"metrics": scratch})
    assert any(f.rule == "AGNO-LAYOUT-002" and "_domain_hash" in f.msg for f in findings), \
        [str(f) for f in findings]


def test_registry_docstring_quote_is_checked(tmp_path):
    """The trace record format the port's registry docstring quotes is read
    by AGNO-LAYOUT-002: a quote that drifts from ``trace._REC`` fails."""
    scratch = _scratch(tmp_path, "core/registry.py",
                       lambda t: t.replace("``'<QQHBBI'``", "``'<QQHBBH'``", 1))
    findings = check_layout([SRC], overrides={"registry": scratch})
    assert any(f.rule == "AGNO-LAYOUT-002" and "quotes trace record format" in f.msg
               for f in findings), [str(f) for f in findings]


# ---------------------------------------------------------------------------
# the model checker: the port's two-step fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", model.PROFILES["fast"])
def test_model_fast_scenario_passes(name):
    stats = model.explore(model.SCENARIOS[name])
    assert stats["terminals"] > 0 and stats["states"] > 500


@pytest.mark.parametrize("bug", ("no_dekker_recheck", "rollback_clobbers_waiters"))
def test_model_catches_the_references_bugs_with_its_kinds(bug):
    with pytest.raises(model.Violation) as port:
        model.explore(model.SCENARIOS["waiter_wakeup"], bug=bug)
    with pytest.raises(ref_model.Violation) as ref:
        ref_model.explore(ref_model.SCENARIOS["waiter_wakeup"], bug=bug)
    assert port.value.kind == ref.value.kind
    if bug == "no_dekker_recheck":
        assert port.value.kind == "lost-wakeup"
        assert any(".f_store" in s for s in port.value.trace)
    else:
        assert port.value.kind in ("waiter-flag-lost", "lost-wakeup")
        assert any("kill(" in s for s in port.value.trace)


def test_model_fold_zeroes_all_loses_a_release_in_fold_race():
    with pytest.raises(model.Violation) as ei:
        model.explore(model.SCENARIOS["fold_race"], bug="fold_zeroes_all")
    assert ei.value.kind == "lost-release"
    trace = list(ei.value.trace)
    assert not any("kill(" in s for s in trace)
    # the counterexample: a subscriber's lock-free byte store lands between
    # the other subscriber's fold read and its zeroing
    read = next(i for i, s in enumerate(trace) if s.endswith(".l_fold_read"))
    folder = trace[read].split(".")[0]
    zero = trace.index(f"{folder}.{trace[read].split('.')[1]}.l_fold_zero")
    between = trace[read + 1:zero]
    assert any(s.endswith(".f_store") and not s.startswith(folder + ".") for s in between), trace


def test_model_fold_steps_follow_the_ports_registry():
    """Every op that folds runs the fold as a read step then a zero step, and
    the reference's model (one atomic fold) has no such step."""
    for build in (lambda: model.op_publish(1, 0, ring=0, subs=(2,), bug=None),
                  lambda: model.op_release(2, 0, bug=None)):
        labels = [lab.split(".")[-1] for lab, _ in build()]
        reads = [i for i, lab in enumerate(labels) if lab.endswith("fold_read")]
        assert len(reads) == 1 and labels[reads[0] + 1].endswith("fold_zero")
        assert "fold" not in labels and "l_fold" not in labels
    ref_labels = [lab for lab, _ in ref_model.op_release(2, 0, bug=None)]
    assert not any(lab.endswith("fold_read") for lab in ref_labels)
    assert "fold_race" not in ref_model.SCENARIOS and "fold_zeroes_all" in model.BUGS


@pytest.mark.parametrize("bug", (None, "fold_zeroes_all"))
def test_model_cli_json(bug):
    cmd = [sys.executable, "-m", "repro_torch.analysis.model", "--scenario", "fold_race",
           "--json"] + (["--bug", bug] if bug else [])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    if bug is None:
        assert out["ok"] and out["results"][0]["scenario"] == "fold_race"
    else:
        assert not out["ok"] and out["violation"]["kind"] == "lost-release"


# ---------------------------------------------------------------------------
# the two registry regressions, against the port's Registry
# ---------------------------------------------------------------------------

@pytest.fixture()
def reg():
    r = Registry.create()
    yield r
    r.close()
    r.unlink()


def test_rollback_preserves_concurrent_waiter_arm(reg):
    """A publisher dying mid-transaction must not wipe another publisher's
    concurrently-armed pub_waiters flag (``tests/test_analysis.py``'s case)."""
    t = reg.topic_index("x")
    p = reg.add_publisher(t, os.getpid(), "arena0", depth=2)
    j = reg._journal[t]
    j["topic_img"] = reg.topics[t].tobytes()
    j["pid"] = _dead_pid()
    j["tidx"], j["pidx"], j["slot"] = t, p, -1
    j["has_topic"], j["has_entry"] = 1, 0
    j["state"] = _J_PENDING
    reg.set_pub_waiter(t, p, True)          # lock-free arm, after the image
    with reg._topic_flock(t):
        reg._recover(t)
    assert reg.pub_waiter(t, p), "rollback clobbered a concurrently-armed waiter flag"


def test_release_notify_uses_effective_held(reg):
    """release()'s freed decision reads the EFFECTIVE held mask: a sibling's
    lock-free byte landing after this release's fold still counts."""
    t = reg.topic_index("x")
    p = reg.add_publisher(t, os.getpid(), "arena0", depth=2)
    sa = reg.add_subscriber(t, os.getpid())
    sb = reg.add_subscriber(t, os.getpid())
    seq, _ = reg.publish(t, p, 0, 8)
    assert len(reg.take(t, sa)) == 1 and len(reg.take(t, sb)) == 1

    real_fold = reg._fold_releases
    state = {"armed": False}

    def fold_then_sibling_byte(tidx, pidx):
        real_fold(tidx, pidx)
        if state["armed"]:                  # B's byte lands after the fold
            reg.entries[tidx, pidx, seq % 2]["released"][sb] = 1
            state["armed"] = False

    notified = []
    reg._fold_releases = fold_then_sibling_byte
    reg._notify_owner = lambda tidx, pidx: notified.append((tidx, pidx))
    try:
        state["armed"] = True
        reg.set_pub_waiter(t, p, True)      # forces A onto the locked path
        reg.release(t, p, sa, seq)
    finally:
        reg._fold_releases = real_fold
    assert (t, p) in notified, "held->0 transition hidden by an unfolded sibling release byte"


# ---------------------------------------------------------------------------
# scripts/agnolint_torch.py end to end
# ---------------------------------------------------------------------------

SCRIPT = os.path.join(ROOT, "scripts", "agnolint_torch.py")


def test_agnolint_torch_strict_fails_a_planted_lock001(tmp_path):
    bad = tmp_path / "repro_torch_fake.py"
    bad.write_text(_LOCK1_BAD)
    report = tmp_path / "report.json"
    r = subprocess.run([sys.executable, SCRIPT, str(bad), "--strict", "--json", str(report)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    data = json.loads(report.read_text())
    assert data["lint"]["counts"] == {"AGNO-LOCK-001": 1}
    assert data["layout"] == []


def test_agnolint_torch_strict_passes_the_tree(tmp_path):
    report = tmp_path / "report.json"
    r = subprocess.run([sys.executable, SCRIPT, "--strict", "--json", str(report)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads(report.read_text())
    assert data["paths"] == [os.path.join("src", "repro_torch")]
    assert data["lint"]["findings"] == [] and data["layout"] == []
    assert all(f.startswith("src/repro_torch/") for f in data["lint"]["files"])
