"""The port's lint (``repro_torch.analysis``) on the CPU.

* The carried-over machinery against the JAX package's
  ``repro.analysis`` on the reference's own snippets
  (``tests/test_analysis.py``): the lock rules and the suppression
  handling give the same rules, lines, columns, symbols and messages
  through both packages' ``lint_source``.  The reference's rule names in
  a suppression map to the port's (``jit-host-sync`` ->
  ``torch-host-sync``), whose catalog has no ``jit-*`` rules.
* The baseline ratchet, the fingerprints and the CLI, as there.
* The port's own rules: each fires on a bad snippet and stays silent on
  a good one.
* The gate itself: ``python -m repro_torch.analysis.lint src/repro_torch
  chip_smoke.py`` exits 0 against ``analysis/baseline_torch.json``, and
  every lock of the port comes from ``make_lock`` under the reference's
  name for it.
"""
import ast
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import engine as JE
from repro.analysis.locks import check_lock_discipline as jlocks
from repro_torch.analysis import engine as TE
from repro_torch.analysis.findings import (RULES, SCHEMA_VERSION, Finding,
                                           load_baseline, save_baseline,
                                           split_new, stale_baseline)
from repro_torch.analysis.hazards import check_hazards
from repro_torch.analysis.kernel_oracle import kernel_wrappers
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.locks import check_lock_discipline as tlocks

REPO = Path(__file__).resolve().parent.parent

LOCKED_CLASS = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []
            self.total = 0

        def add(self, x):
            with self._lock:
                self.items.append(x)
                self.total += 1
"""

# the reference's snippets (tests/test_analysis.py), with the rel path
# each is linted under
LOCK_SNIPPETS = {
    "mixed_mutation_bad": (LOCKED_CLASS + """
        def sneaky(self, x):
            self.items.append(x)
    """, "serving/snippet.py"),
    "all_locked": (LOCKED_CLASS, "serving/snippet.py"),
    "locked_suffix": (LOCKED_CLASS + """
        def _flush_locked(self):
            self.items.clear()
            self.total = 0
    """, "serving/snippet.py"),
    "unlocked_read_bad": (LOCKED_CLASS + """
        def totals(self):
            return (len(self.items), self.total)
    """, "serving/snippet.py"),
    "unlocked_read_under_lock": (LOCKED_CLASS + """
        def totals(self):
            with self._lock:
                return (len(self.items), self.total)
    """, "serving/snippet.py"),
    "single_attr_read": (LOCKED_CLASS + """
        def count(self):
            return len(self.items)
    """, "serving/snippet.py"),
    "private_read": (LOCKED_CLASS + """
        def _peek(self):
            return (len(self.items), self.total)
    """, "serving/snippet.py"),
    "module_global": ("""
        import threading

        _LOCK = threading.Lock()
        _STATS = {"a": 0}

        def bump():
            with _LOCK:
                _STATS["a"] += 1

        def sneaky():
            _STATS["a"] += 1
    """, "kernels/snippet.py"),
    "make_lock_factory": ("""
        from repro_torch.analysis.sanitize import make_lock

        class C:
            def __init__(self):
                self._lock = make_lock("c")
                self.n = 0

            def inc(self):
                with self._lock:
                    self.n += 1

            def sneaky(self):
                self.n = 0
    """, "serving/snippet.py"),
    "suppressed": (LOCKED_CLASS + """
        def sneaky(self, x):
            self.items.append(x)  # lint: ignore[lock-mixed-mutation] -- fixture
    """, "serving/snippet.py"),
    "suppression_block_above": (LOCKED_CLASS + """
        def sneaky(self, x):
            # lint: ignore[lock-mixed-mutation] -- a reason that wraps
            # over two comment lines before the flagged statement
            self.items.append(x)
    """, "serving/snippet.py"),
    "bare_suppression": ("""
        def f():
            return 1  # lint: ignore
    """, "serving/snippet.py"),
    "unknown_rule": ("""
        def f():
            return 1  # lint: ignore[no-such-rule] -- whatever
    """, "serving/snippet.py"),
    "suppression_in_docstring": ('''
        def f():
            """Example: # lint: ignore[lock-mixed-mutation] -- nope."""
            return 1
    ''', "serving/snippet.py"),
    "other_rule_suppressed": (LOCKED_CLASS + """
        def sneaky(self, x):
            self.items.append(x)  # lint: ignore[{sync}] -- wrong rule
    """, "serving/snippet.py"),
}


def _rows(findings):
    return [(f.rule, f.line, f.col, f.symbol, f.message) for f in findings]


@pytest.mark.parametrize("case", sorted(LOCK_SNIPPETS))
def test_lock_rules_and_suppressions_match_reference(case):
    text, rel = LOCK_SNIPPETS[case]
    text = textwrap.dedent(text)
    want = JE.lint_source(text.replace("{sync}", "jit-host-sync"), rel=rel,
                          file_rules=[jlocks])
    got = TE.lint_source(text.replace("{sync}", "torch-host-sync"), rel=rel,
                         file_rules=[tlocks])
    assert _rows(got) == _rows(want)


def test_reference_snippets_fire_as_there():
    """The expected outcomes of the reference's own tests, through the
    port: the bad snippets give their rules, the good ones nothing."""
    def rules(case):
        text, rel = LOCK_SNIPPETS[case]
        text = textwrap.dedent(text).replace("{sync}", "torch-host-sync")
        return [f.rule for f in TE.lint_source(text, rel=rel,
                                               file_rules=[tlocks])]
    assert rules("mixed_mutation_bad") == ["lock-mixed-mutation"]
    assert rules("unlocked_read_bad") == ["lock-unlocked-read"]
    assert rules("module_global") == ["lock-mixed-mutation"]
    assert rules("make_lock_factory") == ["lock-mixed-mutation"]
    assert rules("bare_suppression") == ["bad-suppression"]
    assert rules("unknown_rule") == ["bad-suppression"]
    assert rules("other_rule_suppressed") == ["lock-mixed-mutation"]
    for case in ("all_locked", "locked_suffix", "unlocked_read_under_lock",
                 "single_attr_read", "private_read", "suppressed",
                 "suppression_block_above", "suppression_in_docstring"):
        assert rules(case) == [], case


# ---------------------------------------------------------------------
# the port's own rules: bad and good snippets
# ---------------------------------------------------------------------

HAZARDS = {
    "torch-host-sync": ("""
        import torch

        def step(x):
            n = int(x.sum())
            y = x.cpu()
            torch.cuda.synchronize()
            return n, y, x.max().item(), x.tolist()
    """, "kernels/ops.py", 5, """
        def step(x):
            n = x.sum()
            # lint: ignore[torch-host-sync] -- the op hands host arrays out
            return n, x.cpu()
    """),
    "torch-constant-rebuild": ("""
        import torch

        def step(x):
            return x * torch.tensor([1.0, 2.0], device=x.device)
    """, "models/layers.py", 1, """
        import torch

        _C = torch.tensor([1.0, 2.0])

        def step(x, w):
            strides = torch.tensor([s for s in x.stride()])
            return x * torch.tensor(w, device=x.device), strides
    """),
    "torch-bucket-bypass": ("""
        from repro_torch.kernels.route_step import route_step_body

        def f(*args):
            return route_step_body(*args)
    """, "core/routing.py", 1, """
        from repro_torch.kernels import ops

        def f(*args):
            return ops.route_step(*args)
    """),
    "port-imports-reference": ("""
        import jax.numpy as jnp
        from repro.kernels import ref
        import repro.models.model

        def f():
            from jax import lax
            return lax
    """, "serving/x.py", 4, """
        import torch
        from repro_torch.kernels import ops
        from . import reprocess
    """),
    "kernel-silent-fallback": ("""
        def flash(q, k, v):
            try:
                return _launch(q, k, v)
            except RuntimeError:
                return flash_attention_plain(q, k, v)
    """, "kernels/flash_attention.py", 1, """
        def flash(q, k, v):
            if q.device.type == "cpu":
                return flash_attention_plain(q, k, v)
            try:
                return _launch(q, k, v)
            except RuntimeError as e:
                raise RuntimeError("launch failed") from e
    """),
}


@pytest.mark.parametrize("rule", sorted(HAZARDS))
def test_port_rule_fires_on_bad_and_not_on_good(rule):
    bad, rel, n, good = HAZARDS[rule]
    got = TE.lint_source(textwrap.dedent(bad), rel=rel,
                         file_rules=[check_hazards])
    assert [f.rule for f in got] == [rule] * n
    assert TE.lint_source(textwrap.dedent(good), rel=rel,
                          file_rules=[check_hazards]) == []


def test_host_sync_and_constant_rebuild_only_on_the_hot_path():
    bad, _, _, _ = HAZARDS["torch-host-sync"]
    assert TE.lint_source(textwrap.dedent(bad), rel="serving/runner.py",
                          file_rules=[check_hazards]) == []
    bad, _, _, _ = HAZARDS["torch-constant-rebuild"]
    assert TE.lint_source(textwrap.dedent(bad), rel="core/analyzer.py",
                          file_rules=[check_hazards]) == []
    bad, _, _, _ = HAZARDS["torch-bucket-bypass"]
    assert TE.lint_source(textwrap.dedent(bad), rel="kernels/ops.py",
                          file_rules=[check_hazards]) == []


def _kernel_project(tmp_path, *, plain=True, cpu_test=True, card=True):
    kdir = tmp_path / "src" / "kernels"
    kdir.mkdir(parents=True)
    (kdir / "foo.py").write_text(
        "def foo(x):\n"
        "    if x.device.type == 'cpu':\n"
        "        return foo_plain(x) if PLAIN else x\n"
        "    foo.launches += 1\n"
        "    return x\n\n\n"
        + ("def foo_plain(x):\n    return x\n\n\n" if plain else "")
        + "foo.launches = 0\n")
    tdir = tmp_path / "tests"
    tdir.mkdir()
    (tdir / "test_torch_foo.py").write_text(
        "from repro.kernels import ref as R\n"
        + ("def test():\n    assert foo(R.foo(1)) is not None\n"
           if cpu_test else "def test():\n    pass\n"))
    (tdir / "test_torch_cuda_foo.py").write_text(
        "def test():\n    assert foo(1) == foo_plain(1)\n" if card
        else "def test():\n    pass\n")
    return TE.run_lint([str(tmp_path / "src")], root=str(tmp_path),
                       tests_dir=str(tdir))


def test_kernel_conformance_clean(tmp_path):
    assert _kernel_project(tmp_path).findings == []


@pytest.mark.parametrize("missing,rule", [
    ("plain", "kernel-missing-plain"),
    ("cpu_test", "kernel-missing-oracle-test"),
    ("card", "kernel-missing-card-check")])
def test_kernel_conformance_fires(tmp_path, missing, rule):
    result = _kernel_project(tmp_path, **{missing: False})
    assert [f.rule for f in result.findings] == [rule]
    assert result.findings[0].symbol == "foo"


def test_kernel_wrappers_of_the_port():
    """The rule finds every launch-counting wrapper of the port."""
    found = set()
    for path in sorted((REPO / "src/repro_torch/kernels").glob("*.py")):
        src = TE.Source.parse(str(path), str(REPO))
        found |= {name for name, _, _ in kernel_wrappers(src)}
    assert found == {"router_topk", "router_topk_q8", "bandit_update",
                     "flash_attention", "flash_attention_bwd",
                     "flash_decode_q8", "decode_merge", "ssd_scan",
                     "ssd_scan_bwd", "moe_gating", "moe_gating_bwd"}


# ---------------------------------------------------------------------
# fingerprints, baseline ratchet, CLI
# ---------------------------------------------------------------------

def _f(rule="lock-mixed-mutation", path="a.py", line=3, symbol="C.m",
       message="msg"):
    return Finding(rule=rule, path=path, line=line, col=1, symbol=symbol,
                   message=message)


def test_fingerprints_match_reference():
    from repro.analysis.findings import Finding as JFinding
    for f in (_f(), _f(line=99), _f(message="x")):
        j = JFinding(rule=f.rule, path=f.path, line=f.line, col=f.col,
                     symbol=f.symbol, message=f.message)
        assert f.fingerprint == j.fingerprint and f.to_dict() == j.to_dict()
    assert _f(line=3).fingerprint == _f(line=99).fingerprint
    assert _f(message="x").fingerprint != _f(message="y").fingerprint


def test_baseline_ratchet(tmp_path):
    bl = tmp_path / "baseline.json"
    save_baseline(str(bl), [_f(), _f(line=9)])
    counts = load_baseline(str(bl))
    assert counts == {_f().fingerprint: 2}
    new, old = split_new([_f(), _f(line=9), _f(message="other")], counts)
    assert [x.message for x in new] == ["other"] and len(old) == 2
    new, old = split_new([_f(), _f(line=50)], {_f().fingerprint: 1})
    assert len(new) == 1 and len(old) == 1
    stale = stale_baseline([_f()], {_f().fingerprint: 2,
                                    _f(message="gone").fingerprint: 1})
    assert stale == {_f().fingerprint: 1, _f(message="gone").fingerprint: 1}
    assert load_baseline(str(tmp_path / "nope.json")) == {}


def test_cli_ratchet_lifecycle_and_json(tmp_path, capsys):
    pkg = tmp_path / "src"
    pkg.mkdir()
    bad = textwrap.dedent(LOCK_SNIPPETS["mixed_mutation_bad"][0])
    (pkg / "mod.py").write_text(bad)
    bl = str(tmp_path / "analysis" / "baseline_torch.json")
    args = [str(pkg), "--root", str(tmp_path), "--baseline", bl]
    assert lint_main(args) == 1
    assert lint_main(args + ["--write-baseline"]) == 0
    assert lint_main(args) == 0
    (pkg / "mod2.py").write_text(bad)
    assert lint_main(args) == 1
    capsys.readouterr()
    assert lint_main([str(pkg), "--root", str(tmp_path), "--no-baseline",
                      "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema_version"] == SCHEMA_VERSION
    assert set(doc) == {"schema_version", "n_files", "findings",
                        "baselined", "stale_baseline", "errors"}
    assert doc["n_files"] == 2 and len(doc["findings"]) == 2
    assert doc["findings"][0]["path"] == "src/mod.py"
    (pkg / "broken.py").write_text("def f(:\n")
    assert lint_main([str(pkg), "--root", str(tmp_path), "--no-baseline"]) \
        == 2
    capsys.readouterr()


def test_rule_catalog_pinned():
    assert set(RULES) == {
        "lock-mixed-mutation", "lock-unlocked-read", "torch-host-sync",
        "torch-constant-rebuild", "torch-bucket-bypass",
        "port-imports-reference", "kernel-silent-fallback",
        "kernel-missing-plain", "kernel-missing-oracle-test",
        "kernel-missing-card-check", "bad-suppression"}


# ---------------------------------------------------------------------
# the gate on the port itself
# ---------------------------------------------------------------------

def test_port_lints_clean_against_its_baseline(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert lint_main(["src/repro_torch", "chip_smoke.py"]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
    assert (REPO / "analysis" / "baseline_torch.json").is_file()


def _lock_names(root):
    """{module path under the package: [make_lock names]}, and the
    direct ``threading.Lock()`` calls outside analysis/."""
    names, raw = {}, []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("analysis/"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            fname = fn.id if isinstance(fn, ast.Name) else getattr(
                fn, "attr", None)
            if fname in ("make_lock", "_make_lock") and node.args:
                names.setdefault(rel, []).append(node.args[0].value)
            elif fname in ("Lock", "RLock"):
                raw.append(rel)
    return names, raw


def test_port_locks_come_from_make_lock_under_reference_names():
    want, _ = _lock_names(REPO / "src" / "repro")
    got, raw = _lock_names(REPO / "src" / "repro_torch")
    assert raw == []
    assert got.pop("kernels/build.py") == ["kernels.build"]
    assert got == want


def test_analysis_package_is_a_leaf():
    """Nothing in ``repro_torch/analysis`` imports torch, numpy or the
    rest of the port at module scope (``make_lock`` stays cheap and
    cycle-free for every module that takes its locks from it)."""
    for path in sorted((REPO / "src/repro_torch/analysis").glob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("torch", "numpy"), path
                assert not mod.startswith("repro_torch.") or \
                    mod.startswith("repro_torch.analysis"), (path, mod)
