"""The port's apexlint (``ape_x_dqn_tpu_torch/analysis``, ``ape_x_dqn_tpu_torch/lint.py``)
held against the JAX package's (``ape_x_dqn_tpu/analysis``, ``tools/lint.py``).

Layers, as in ``tests/test_lint.py``:

  * **fixture twins** — one case per JAX fixture test: the tree under
    tests/fixtures/lint/ goes through both packages' ``check`` with the
    same options, and the lists of ``(checker, path, line, key, message)``
    must be identical; the port's findings are also held to the JAX test's
    own expectations;
  * **the baseline protocol**, in both packages and across them (a file one
    writes, the other reads);
  * **the port's tree** lints clean with its empty baseline (one scan for
    the module), its CLI is clean and fast, and each contracted module loads
    no torch, no jax and nothing of the JAX package in a fresh interpreter;
  * **mutations** of a copy of the port's tree: each checker fires with its
    key on the fault it exists for;
  * **cross-package pins**: the wire registry, the config schema and the
    declared metric names are the JAX package's;
  * **doc-schema twins**: the port's runtime dicts against docs/METRICS.md.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from ape_x_dqn_tpu import analysis as jax_analysis
from ape_x_dqn_tpu.analysis import core as jax_core
from ape_x_dqn_tpu_torch import analysis
from ape_x_dqn_tpu_torch.analysis import core, metrics_doc

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
PACKAGES = ("ape_x_dqn_tpu", "ape_x_dqn_tpu_torch")


def _check(pkg: str, checker: str, tree: str, rel: str, **kw) -> list:
    """One checker of one package over one fixture tree, as plain tuples."""
    mod = importlib.import_module(f"{pkg}.analysis.{checker}")
    pcore = importlib.import_module(f"{pkg}.analysis.core")
    repo = pcore.Repo(os.path.join(FIXTURES, tree), rel_dirs=(rel,))
    return [dataclasses.astuple(f) for f in mod.check(repo, **kw)]


def _by_key(rows) -> dict:
    """key -> (path, line, message) of one run's findings."""
    return {key: (path, line, msg) for _checker, path, line, key, msg in rows}


# ---------------------------------------------------------------------------
# Fixture twins: one case per fixture test of tests/test_lint.py.
# ---------------------------------------------------------------------------

_IL = ("import_light", "import_light", "fixpkg")
_WIRE = ("wire_registry", "wire", "wirepkg")
_WIRE_OPTS = dict(net_path="wirepkg/net.py", allowed_dupes={}, wire_plane=())
_CONF = ("config_coverage", "config_cov", "confpkg")
_CONF_OPTS = dict(config_path="confpkg/config.py",
                  doc_text="actor.num_actors and actor.documented_knob")
_METRICS = ("metrics_doc", "metrics", "metricspkg")
_SHM = ("shm_discipline", "shm", "shmpkg")
_ERR = ("typed_errors", "errors", "errpkg")
_ALLOW = {b"TSTA": {"files": frozenset({"wirepkg/net.py", "wirepkg/consumer.py"}),
                    "reason": "fixture"}}
_ALLOW_DRIFT = {b"TSTB": {"files": frozenset({"wirepkg/net.py"}), "reason": "fixture"}}

# (JAX test, runs [(checker, tree, rel, options)], expectation over the
# port's runs, each a {key: (path, line, message)} dict).
FIXTURE_CASES = [
    ("TestImportLightChecker::test_transitive_smuggle_found_with_chain",
     [(*_IL, dict(roots=("fixpkg.entry",)))],
     lambda r: (list(r[0]) == ["fixpkg.entry->jax"]
                and r[0]["fixpkg.entry->jax"][:2] == ("fixpkg/middle.py", 3)
                and "fixpkg.entry -> fixpkg.middle" in r[0]["fixpkg.entry->jax"][2])),
    ("TestImportLightChecker::test_function_scope_import_is_legal",
     [(*_IL, dict(roots=("fixpkg.lazy_ok",)))],
     lambda r: r[0] == {}),
    ("TestImportLightChecker::test_missing_contract_root_is_a_finding",
     [(*_IL, dict(roots=("fixpkg.nonexistent",)))],
     lambda r: list(r[0]) == ["missing-root:fixpkg.nonexistent"]),
    ("TestWireRegistryChecker::test_duplicate_kind_value",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: r[0]["dup-kind-value:F_B"][:2] == ("wirepkg/net.py", 4)),
    ("TestWireRegistryChecker::test_dead_kind",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: (r[0]["dead-kind:F_C"][:2] == ("wirepkg/net.py", 5)
                and "dead-kind:F_B" in r[0])),
    ("TestWireRegistryChecker::test_redeclared_kind_outside_registry",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: r[0]["redeclared-kind:wirepkg/consumer.py:F_D"][:2]
     == ("wirepkg/consumer.py", 3)),
    ("TestWireRegistryChecker::test_duplicate_magic",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: (r[0]["dup-magic:wirepkg/consumer.py:MAGIC_TWO"][:2]
                == ("wirepkg/consumer.py", 4)
                and "MAGIC_ONE" in r[0]["dup-magic:wirepkg/consumer.py:MAGIC_TWO"][2])),
    ("TestWireRegistryChecker::test_kind_literal_compare",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: r[0]["kind-literal:wirepkg/consumer.py:2"][:2] == ("wirepkg/consumer.py", 15)),
    ("TestWireRegistryChecker::test_dispatch_without_reject_path",
     [(*_WIRE, _WIRE_OPTS)],
     lambda r: (r[0]["no-reject-path:wirepkg/consumer.py:decode"][0] == "wirepkg/consumer.py"
                and "no-reject-path:wirepkg/consumer.py:route" not in r[0]
                and len(r[0]) == 7)),
    ("TestWireRegistryChecker::test_wire_plane_magic_declaration",
     [(*_WIRE, dict(_WIRE_OPTS, wire_plane=("wirepkg/consumer.py",)))],
     lambda r: "wire-plane-magic:wirepkg/consumer.py:MAGIC_TWO" in r[0]),
    ("TestWireRegistryChecker::test_allowed_dupe_suppresses_and_guards_drift",
     [(*_WIRE, dict(_WIRE_OPTS, allowed_dupes=_ALLOW)),
      (*_WIRE, dict(_WIRE_OPTS, allowed_dupes=_ALLOW_DRIFT))],
     lambda r: (not any(k.startswith("dup-magic:") for k in r[0])
                and any(k.startswith("dupe-drift:wirepkg/net.py") for k in r[1]))),
    ("TestConfigCoverageChecker::test_ghost_attribute_read",
     [(*_CONF, _CONF_OPTS)],
     lambda r: r[0]["ghost:actor.ghost_knob"][:2] == ("confpkg/reader.py", 6)),
    ("TestConfigCoverageChecker::test_ghost_getattr_read",
     [(*_CONF, _CONF_OPTS)],
     lambda r: r[0]["ghost:actor.ghost_via_getattr"][:2] == ("confpkg/reader.py", 7)),
    ("TestConfigCoverageChecker::test_undocumented_knob",
     [(*_CONF, _CONF_OPTS)],
     lambda r: r[0]["undocumented:actor.ghost_target"][:2] == ("confpkg/config.py", 11)),
    ("TestConfigCoverageChecker::test_declared_and_documented_reads_are_clean",
     [(*_CONF, _CONF_OPTS)],
     lambda r: ("ghost:actor.num_actors" not in r[0]
                and "undocumented:actor.num_actors" not in r[0] and len(r[0]) == 3)),
    ("TestMetricsDocChecker::test_undocumented_names_fire_documented_dont",
     [(*_METRICS, dict(doc_text="the doc mentions `good/counter` only"))],
     lambda r: (r[0]["instrument:bad/undocumented_gauge"][:2]
                == ("metricspkg/bad_metrics.py", 6)
                and r[0]["section:ghost_section"][1] == 7
                and "instrument:good/counter" not in r[0] and len(r[0]) == 2)),
    ("TestShmDisciplineChecker::test_raw_create_fires_attach_does_not",
     [(*_SHM, dict(blessed="elsewhere.py"))],
     lambda r: (list(r[0]) == ["raw-create:shmpkg/raw_shm.py:make"]
                and r[0]["raw-create:shmpkg/raw_shm.py:make"][:2] == ("shmpkg/raw_shm.py", 7))),
    ("TestShmDisciplineChecker::test_blessed_module_is_exempt",
     [(*_SHM, dict(blessed="shmpkg/raw_shm.py"))],
     lambda r: r[0] == {}),
    ("TestTypedErrorsChecker::test_bare_and_unjustified_fire_justified_and_narrow_dont",
     [(*_ERR, dict(dirs=("errpkg",)))],
     lambda r: (r[0]["bare-except:errpkg/bad_except.py:decode:0"][1] == 8
                and r[0]["silent-swallow:errpkg/bad_except.py:cleanup:0"][1] == 15
                and len(r[0]) == 2)),
    ("TestTypedErrorsChecker::test_out_of_scope_dirs_are_ignored",
     [(*_ERR, dict(dirs=("otherdir",)))],
     lambda r: r[0] == {}),
]


@pytest.mark.parametrize("case", FIXTURE_CASES, ids=[c[0].split("::")[1] for c in FIXTURE_CASES])
def test_fixture_findings_match_jax(case):
    _name, runs, expect = case
    port_runs = []
    for checker, tree, rel, opts in runs:
        want = _check("ape_x_dqn_tpu", checker, tree, rel, **opts)
        got = _check("ape_x_dqn_tpu_torch", checker, tree, rel, **opts)
        assert got == want
        assert all(row[0] == checker.replace("_", "-") for row in got)
        port_runs.append(_by_key(got))
    assert expect(port_runs), port_runs


def test_doc_section_keys_parses_real_doc_as_jax_does():
    """Twin of ``test_doc_section_keys_parses_real_doc``, over every section
    header of docs/METRICS.md."""
    from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys as jax_keys

    keys = metrics_doc.doc_section_keys("## Supervisor schema")
    assert "respawns" in keys and "watchdog" in keys
    with open(os.path.join(REPO, "docs", "METRICS.md"), encoding="utf-8") as f:
        headers = [ln.rstrip("\n") for ln in f if ln.startswith("## ")]
    assert len(headers) > 10
    for header in headers:
        assert metrics_doc.doc_section_keys(header) == jax_keys(header), header
    assert metrics_doc.doc_section_keys("## No such section") == []


# ---------------------------------------------------------------------------
# Baseline protocol.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", [jax_analysis, analysis], ids=PACKAGES)
def test_reasonless_baseline_entry_rejected(pkg, tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [{"checker": "x", "key": "y", "reason": "  "}]}))
    with pytest.raises(ValueError, match="no reason"):
        pkg.load_baseline(str(p))


def test_suppression_and_stale_reporting_match_jax(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [
        {"checker": "c", "key": "k1", "reason": "known-WAI"},
        {"checker": "c", "key": "gone", "reason": "fixed long ago"},
    ]}))
    results = []
    for pkg in (jax_analysis, analysis):
        f1 = pkg.Finding("c", "a.py", 1, "k1", "m1")
        f2 = pkg.Finding("c", "b.py", 2, "k2", "m2")
        res = pkg.apply_baseline([f1, f2], pkg.load_baseline(str(p)))
        results.append(([f.key for f in res.new], [f.key for f in res.suppressed],
                         res.stale_baseline, res.ok))
    assert results[1] == results[0]
    assert results[1] == (["k2"], ["k1"], [{"checker": "c", "key": "gone",
                                            "reason": "fixed long ago"}], False)


@pytest.mark.parametrize("writer,reader", [(jax_analysis, analysis), (analysis, jax_analysis)],
                         ids=["jax_writes_port_reads", "port_writes_jax_reads"])
def test_baseline_file_crosses_packages(writer, reader, tmp_path):
    """A baseline one package writes, the other loads and applies the same way
    (``--write-baseline``'s placeholder reasons are reasons)."""
    p = str(tmp_path / "baseline.json")
    found = [writer.Finding("wire-registry", "x.py", 3, "dead-kind:F_Z", "m"),
             writer.Finding("typed-errors", "y.py", 9, "bare-except:y.py:f:0", "m")]
    writer.write_baseline(found, path=p)
    loaded = reader.load_baseline(p)
    assert loaded == writer.load_baseline(p)
    assert set(loaded) == {("wire-registry", "dead-kind:F_Z"),
                           ("typed-errors", "bare-except:y.py:f:0")}
    mine = [reader.Finding(*dataclasses.astuple(f)) for f in found[:1]]
    res = reader.apply_baseline(mine, loaded)
    assert res.ok and [f.key for f in res.suppressed] == ["dead-kind:F_Z"]
    assert [e["key"] for e in res.stale_baseline] == ["bare-except:y.py:f:0"]


def test_committed_baseline_loads_and_is_empty():
    assert analysis.load_baseline() == {}
    with open(analysis.BASELINE_PATH, encoding="utf-8") as f:
        assert json.load(f)["entries"] == []


# ---------------------------------------------------------------------------
# The port's tree.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_tree():
    """One scan of the committed port tree for the whole module."""
    repo = core.Repo(REPO)
    return repo, analysis.run_all(repo)


@pytest.mark.parametrize("checker", list(analysis.CHECKERS) + ["parse-error"])
def test_committed_port_tree_lints_clean(port_tree, checker):
    repo, findings = port_tree
    assert repo.files and all(p.startswith("ape_x_dqn_tpu_torch/") for p in repo.files)
    result = analysis.apply_baseline(findings, analysis.load_baseline())
    new = [f for f in result.new if f.checker == checker]
    assert not new, "NEW lint findings:\n" + "\n".join(f.render() for f in new)


def test_checker_ids_are_jax_ids():
    assert list(analysis.CHECKERS) == list(jax_analysis.CHECKERS)


ALLOWED_FILES = sorted(core.ALLOWED_MAGIC_DUPES[b"APXT"]["files"])


def test_contract_data_names_the_port():
    """Every path and module the contracts name exists in the port, and the
    import-light contract is JAX's, less the tool that has no counterpart."""
    files = set(core.Repo(REPO).files)
    for path in (core.NET_REGISTRY_PATH, core.SHM_BLESSED_PATH, core.CONFIG_PATH,
                 *core.METRICS_EXCLUDED_PATHS,
                 *(p for p in core.WIRE_PLANE_PATHS if p.endswith(".py")),
                 *ALLOWED_FILES):
        assert path in files, path
    for d in (*core.TYPED_ERROR_DIRS, *(p for p in core.WIRE_PLANE_PATHS if p.endswith("/"))):
        assert os.path.isdir(os.path.join(REPO, d)), d
    assert core.HEAVY_IMPORTS == jax_core.HEAVY_IMPORTS
    port_of = {"tools.host_join": "ape_x_dqn_tpu_torch.host_join",
               "tools.lint": "ape_x_dqn_tpu_torch.lint"}
    want = [port_of.get(m, m.replace("ape_x_dqn_tpu.", "ape_x_dqn_tpu_torch.", 1))
            for m in jax_core.IMPORT_LIGHT_CONTRACT if m != "tools.xp_transport"]
    assert list(core.IMPORT_LIGHT_CONTRACT) == want
    assert set(core.ALLOWED_MAGIC_DUPES) == set(jax_core.ALLOWED_MAGIC_DUPES)
    assert core.TYPED_ERROR_DIRS == tuple(
        d.replace("ape_x_dqn_tpu/", "ape_x_dqn_tpu_torch/", 1) for d in jax_core.TYPED_ERROR_DIRS)



def _run_cli(*args, timeout=60):
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    return proc, time.monotonic() - t0


def test_cli_json_clean_fast_and_lists_jax_checker_ids():
    proc, seconds = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert seconds < 10.0, seconds
    payload = json.loads(proc.stdout)
    assert payload["ok"] is True and payload["new"] == [] and payload["stale_baseline"] == []
    assert payload["checkers"] == list(jax_analysis.CHECKERS)
    assert payload["files_scanned"] > 50


def test_cli_human_report_and_only(tmp_path):
    proc, _ = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--fail-on-new")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# apexlint: clean" in proc.stdout
    proc, _ = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--json",
                       "--only", "shm-discipline,typed-errors")
    assert proc.returncode == 0
    assert json.loads(proc.stdout)["checkers"] == ["shm-discipline", "typed-errors"]
    proc, _ = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--only", "no-such-checker")
    assert proc.returncode == 2 and "unknown checker ids" in proc.stderr


@pytest.mark.parametrize("cli", [("-m", "tools.lint"), ("-m", "ape_x_dqn_tpu_torch.lint")],
                         ids=PACKAGES)
def test_cli_baseline_errors_and_stale_entries(cli, tmp_path):
    """Both CLIs: a reasonless entry exits 2; a stale entry is reported and
    the run stays clean (one cheap checker keeps the three runs short)."""
    cli = (*cli, "--only", "typed-errors")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"entries": [{"checker": "x", "key": "y", "reason": ""}]}))
    proc, _ = _run_cli(*cli, "--baseline", str(bad))
    assert proc.returncode == 2 and "BASELINE ERROR" in proc.stderr
    stale = tmp_path / "stale.json"
    entry = {"checker": "typed-errors", "key": "bare-except:gone.py:f:0", "reason": "fixed"}
    stale.write_text(json.dumps({"entries": [entry]}))
    proc, _ = _run_cli(*cli, "--baseline", str(stale), "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["stale_baseline"] == [entry]
    proc, _ = _run_cli(*cli, "--baseline", str(stale))
    assert "stale baseline entry (suppresses nothing): typed-errors:bare-except:gone.py:f:0" \
        in proc.stdout


@pytest.mark.parametrize("module", core.IMPORT_LIGHT_CONTRACT)
def test_contracted_module_loads_no_torch_jax_or_jax_package(module):
    """The runtime twin of the static walk, in a fresh interpreter."""
    code = (
        "import json, sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('torch', 'jax', 'jaxlib', 'flax', 'optax', 'ape_x_dqn_tpu'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, (module, proc.stderr[-2000:])
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------------
# Mutations of a copy of the port's tree.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    """The port's python files and the two docs the checkers read."""
    root = tmp_path_factory.mktemp("port_tree")
    shutil.copytree(os.path.join(REPO, "ape_x_dqn_tpu_torch"),
                    os.path.join(root, "ape_x_dqn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu", "*.cc", "*.conf"))
    os.makedirs(os.path.join(root, "docs"))
    shutil.copy(os.path.join(REPO, "docs", "METRICS.md"), os.path.join(root, "docs"))
    shutil.copy(os.path.join(REPO, "README.md"), root)
    return str(root)


def _mutate(root: str, rel: str, old: str | None, new: str) -> None:
    path = os.path.join(root, "ape_x_dqn_tpu_torch", rel)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if old is None:
        text += new
    else:
        assert text.count(old) == 1, (rel, old)
        text = text.replace(old, new)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


_NET = "runtime/net.py"
_FUTURE = "from __future__ import annotations\n"

# (id, file, text replaced or None to append, new text, checker, key)
MUTATIONS = [
    ("import_torch_in_net", _NET, _FUTURE, _FUTURE + "\nimport torch\n",
     "import-light", "ape_x_dqn_tpu_torch.runtime.net->torch"),
    ("duplicate_kind_value", _NET, "F_XP = 1 ", "F_XP = 1\nF_ZZ_MUTANT = 1 ",
     "wire-registry", "dup-kind-value:F_ZZ_MUTANT"),
    ("ghost_learner_knob", "runtime/components.py", None,
     "\n\ndef _mutant(cfg):\n    return cfg.learner.mutant_ghost_knob\n",
     "config-coverage", "ghost:learner.mutant_ghost_knob"),
    ("undocumented_counter", "runtime/supervisor.py", None,
     "\n\ndef _mutant(reg):\n    return reg.counter(\"mutant/undocumented_total\")\n",
     "metrics-doc", "instrument:mutant/undocumented_total"),
    ("raw_shared_memory_create", "runtime/process_actors.py", None,
     "\n\ndef _mutant():\n    from multiprocessing.shared_memory import SharedMemory\n"
     "    return SharedMemory(name=\"x\", create=True, size=8)\n",
     "shm-discipline", "raw-create:ape_x_dqn_tpu_torch/runtime/process_actors.py:_mutant"),
    ("bare_except_in_replay", "replay/buffer.py", None,
     "\n\ndef _mutant():\n    try:\n        return 1\n    except:\n        return 0\n",
     "typed-errors", "bare-except:ape_x_dqn_tpu_torch/replay/buffer.py:_mutant:0"),
]


@pytest.mark.parametrize("mutation", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_mutation_fires_its_checker(mutation, pristine, tmp_path):
    _id, rel, old, new, checker, key = mutation
    root = str(tmp_path / "tree")
    shutil.copytree(pristine, root)
    assert analysis.CHECKERS[checker](core.Repo(root)) == []
    _mutate(root, rel, old, new)
    found = analysis.CHECKERS[checker](core.Repo(root))
    hits = [f for f in found if f.key == key]
    assert len(hits) == 1, [f.render() for f in found]
    assert hits[0].checker == checker
    assert hits[0].path.startswith("ape_x_dqn_tpu_torch/")
    if checker == "import-light":
        # Every contracted root that reaches net.py names its chain.
        svc = [f for f in found if f.key == "ape_x_dqn_tpu_torch.replay.service->torch"]
        assert len(svc) == 1 and svc[0].path == "ape_x_dqn_tpu_torch/runtime/net.py"
        assert svc[0].message.startswith("ape_x_dqn_tpu_torch.replay.service is contracted")
        assert "-> ape_x_dqn_tpu_torch.runtime.net (" in svc[0].message


def test_cli_fails_on_a_mutated_tree(pristine, tmp_path):
    root = str(tmp_path / "tree")
    shutil.copytree(pristine, root)
    _mutate(root, "replay/buffer.py", None,
            "\n\ndef _mutant():\n    try:\n        return 1\n    except:\n        return 0\n")
    proc, _ = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--root", root, "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is False
    assert [f["key"] for f in payload["new"]] == [
        "bare-except:ape_x_dqn_tpu_torch/replay/buffer.py:_mutant:0"]
    proc, _ = _run_cli("-m", "ape_x_dqn_tpu_torch.lint", "--root", root, "--no-fail",
                       "--only", "typed-errors")
    assert proc.returncode == 0 and "1 NEW finding(s)" in proc.stdout


# ---------------------------------------------------------------------------
# Cross-package pins (tests only: they import both packages).
# ---------------------------------------------------------------------------


def test_wire_kinds_and_magics_equal_jax():
    import ape_x_dqn_tpu.runtime.net as jnet
    import ape_x_dqn_tpu_torch.runtime.net as tnet

    def registry(mod):
        return {n: getattr(mod, n) for n in dir(mod)
                if (n.startswith("F_") and isinstance(getattr(mod, n), int))
                or ("MAGIC" in n and isinstance(getattr(mod, n), bytes))}

    want, got = registry(jnet), registry(tnet)
    assert got == want
    assert sum(n.startswith("F_") for n in got) == 14
    # Every module-scope 4-byte magic, by file under its package.
    from ape_x_dqn_tpu.analysis import wire_registry as jwire
    from ape_x_dqn_tpu_torch.analysis import wire_registry as twire

    def magics(wire, pcore, pkg):
        repo = pcore.Repo(REPO, rel_dirs=(pkg,))
        return {(p.split("/", 1)[1], n): v for p, n, v, _ in wire._magic_decls(repo)}

    assert magics(twire, core, "ape_x_dqn_tpu_torch") == magics(jwire, jax_core, "ape_x_dqn_tpu")


def test_config_sections_and_knobs_equal_jax():
    from ape_x_dqn_tpu.config import ApexConfig as JaxConfig
    from ape_x_dqn_tpu_torch.config import ApexConfig

    def schema(cls):
        out = {}
        for f in dataclasses.fields(cls):
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            out[f.name] = (sorted(x.name for x in dataclasses.fields(default))
                           if dataclasses.is_dataclass(default) else None)
        return out

    assert schema(ApexConfig) == schema(JaxConfig)
    sections = {k for k, v in schema(ApexConfig).items() if v is not None}
    assert len(sections) == 10
    # The checker's static model of the port's config agrees.
    from ape_x_dqn_tpu_torch.analysis import config_coverage

    parsed, _ = config_coverage._declared_sections(core.Repo(REPO), core.CONFIG_PATH,
                                                   core.CONFIG_ROOT_CLASS)
    assert {k: sorted(v) for k, v in parsed.items()} == {
        k: v for k, v in schema(ApexConfig).items() if v is not None}


def test_declared_metric_names_equal_jax():
    from ape_x_dqn_tpu.analysis import metrics_doc as jmetrics

    jax_repo = jax_core.Repo(REPO, rel_dirs=("ape_x_dqn_tpu",))
    jax_names = {(k, n) for k, n, _, _ in jmetrics._declared_names(
        jax_repo, ("ape_x_dqn_tpu/obs/registry.py", "ape_x_dqn_tpu/utils/metrics.py"))}
    port_names = {(k, n) for k, n, _, _ in metrics_doc._declared_names(
        core.Repo(REPO), core.METRICS_EXCLUDED_PATHS)}
    assert port_names == jax_names
    assert len(port_names) == 37
    assert {k for k, _ in port_names} == {"instrument", "section"}


# ---------------------------------------------------------------------------
# Doc-schema twins of TestDocSchemaDicts: the port's runtime dicts against
# docs/METRICS.md, through the port's parser.
# ---------------------------------------------------------------------------


def test_net_section_matches_doc():
    from ape_x_dqn_tpu_torch.runtime.net import NetTransport

    doc = metrics_doc.doc_section_keys("## Net transport schema")
    assert doc, "Net transport schema doc section missing"
    tr = NetTransport()
    try:
        stats = tr.stats()
    finally:
        tr.close()
    assert set(doc) == set(stats), set(doc) ^ set(stats)


def test_serving_net_section_matches_doc():
    from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer

    class _Stub:
        param_version = 0

        def submit(self, obs):
            raise AssertionError("never called")

    doc = metrics_doc.doc_section_keys("## Serving net schema")
    assert doc, "Serving net schema doc section missing"
    srv = ServingNetServer(_Stub())
    try:
        stats = srv.stats()
    finally:
        srv.close()
    assert set(doc) == set(stats), set(doc) ^ set(stats)


def test_serving_router_section_matches_doc():
    from ape_x_dqn_tpu_torch.serving.router import ServingRouter

    doc = metrics_doc.doc_section_keys("## Serving router schema")
    assert doc, "Serving router schema doc section missing"
    router = ServingRouter(port=0)
    try:
        stats = router.stats()
    finally:
        router.close()
    assert set(doc) == set(stats), set(doc) ^ set(stats)


def test_replay_tier_section_matches_doc(tmp_path):
    from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
    from ape_x_dqn_tpu_torch.types import DedupChunk

    doc = metrics_doc.doc_section_keys("## Replay tier schema")
    assert doc, "Replay tier schema doc section missing"
    rep = DedupReplay(64, (6, 6, 1), hot_frame_budget_bytes=128,
                      spill_dir=str(tmp_path), spill_span_frames=4)
    r = np.random.default_rng(0)
    rep.add(
        (np.abs(r.normal(size=8)) + 0.1).astype(np.float32),
        DedupChunk(
            frames=r.integers(0, 255, (9, 6, 6, 1), dtype=np.uint8),
            obs_ref=np.arange(8, dtype=np.int32),
            next_ref=np.arange(1, 9, dtype=np.int32),
            action=r.integers(0, 3, 8).astype(np.int32),
            reward=r.normal(size=8).astype(np.float32),
            discount=np.full(8, 0.9, np.float32),
            source=1, chunk_seq=0, prev_frames=9,
        ),
    )
    rep.spill_cold()
    rep.sample(8, rng=np.random.default_rng(1))  # faults cold spans
    stats = rep.tier_stats()
    assert stats["fault_reads"] > 0
    assert set(doc) == set(stats), set(doc) ^ set(stats)
    for key in ("count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
        assert key in stats["fault_ms"], key
