"""nhdlint for the port (nhd_tpu_torch/analysis/), held to the reference.

* Every fixture of tests/fixtures/analysis/ goes through both packages'
  analysers. For the port the fixture tree is re-laid in a temporary
  directory with the ``nhd_tpu`` path part renamed ``nhd_tpu_torch`` (the
  race pack's scope is the package's path part); no fixture file is
  added. For the packs the port carries as copies, the findings are
  equal: rule, line, column and message (package name and fixture root
  substituted), per file and over the whole tree as one project; the
  two rules kept as they were in re-aimed packs (NHD108, NHD720) flag
  the same sites.
* The cases of tests/test_lockgraph.py, tests/test_race_analysis.py and
  tests/test_lint_regressions.py, run against the port: each module's
  text with ``nhd_tpu`` read as ``nhd_tpu_torch`` and its fixture root
  the re-laid tree.
* Positive and negative fixtures, inline, for each torch-aimed NHD1xx
  rule and each ABI-aimed NHD7xx rule.
* The live tree: ``python -m nhd_tpu_torch.analysis nhd_tpu_torch`` exits
  0 with no baseline in a fresh interpreter where jax cannot import,
  and the repairs the port's lint asked for stay made.
"""

from __future__ import annotations

import atexit
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
import types
from pathlib import Path

import pytest

from nhd_tpu.analysis import analyze_file as ref_analyze_file
from nhd_tpu.analysis import analyze_paths as ref_analyze_paths
from nhd_tpu_torch.analysis import analyze_file, analyze_paths
from tests.conftest import subprocess_env

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
FIXTURES = TESTS / "fixtures" / "analysis"
PORT = ROOT / "nhd_tpu_torch"

#: the packs the port carries as verbatim copies
COPIED_PACKS = ["locks", "excepts", "determinism", "fencing", "lockgraph",
                "metrics", "races"]
#: rules of re-aimed packs that the port keeps as the reference has them
KEPT_RULES = {"tracing": "NHD108", "contract": "NHD720"}


def _relay(src: Path, dst: Path) -> None:
    """Copy the fixture tree, renaming the path part ``nhd_tpu``."""
    for path in src.rglob("*"):
        rel = Path(*("nhd_tpu_torch" if p == "nhd_tpu" else p
                     for p in path.relative_to(src).parts))
        if path.is_dir():
            (dst / rel).mkdir(parents=True, exist_ok=True)
        elif path.suffix == ".py":
            (dst / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, dst / rel)


# the re-laid tree lives for this test process: the ported test modules
# below bind their fixture root at import, as the originals do. It ends
# in "analysis", as the original does: module labels are a path's last
# two parts.
_TMP = tempfile.mkdtemp(prefix="nhdlint-port-fixtures-")
atexit.register(shutil.rmtree, _TMP, True)
RELAID = Path(_TMP) / "analysis"
_relay(FIXTURES, RELAID)


def _port_rel(rel: Path) -> Path:
    return Path(*("nhd_tpu_torch" if p == "nhd_tpu" else p for p in rel.parts))


def _norm(findings, root: Path) -> list:
    """(rule, line, col, message) with the fixture root and the package
    name read as the reference's."""
    out = []
    for f in findings:
        msg = f.message.replace(root.as_posix(), FIXTURES.as_posix())
        msg = re.sub(r"\bnhd_tpu_torch\b", "nhd_tpu", msg)
        out.append((f.rule, f.line, f.col, msg))
    return sorted(out)


FIXTURE_FILES = sorted(
    str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*.py")
)


def test_fixture_tree_relaid_whole():
    assert len(FIXTURE_FILES) >= 40
    for rel in FIXTURE_FILES:
        assert (RELAID / _port_rel(Path(rel))).exists(), rel
    assert not (RELAID / "nhd_tpu").exists()


@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_copied_packs_find_what_the_reference_finds(rel):
    ref = ref_analyze_file(FIXTURES / rel, COPIED_PACKS)
    port = analyze_file(RELAID / _port_rel(Path(rel)), COPIED_PACKS)
    assert _norm(port.findings, RELAID) == _norm(ref.findings, FIXTURES)
    assert port.suppressed == ref.suppressed
    assert port.unused_ignores == ref.unused_ignores
    assert port.skipped == ref.skipped
    for pack, rule in KEPT_RULES.items():
        want = [f for f in ref_analyze_file(FIXTURES / rel, [pack]).findings
                if f.rule == rule]
        got = [f for f in analyze_file(RELAID / _port_rel(Path(rel)),
                                       [pack]).findings if f.rule == rule]
        # same sites; the message is the re-aimed pack's own
        assert [(f.rule, f.line, f.col) for f in got] == \
            [(f.rule, f.line, f.col) for f in want], rule


def test_copied_packs_over_the_whole_fixture_tree():
    """All fixtures as one project (the project packs see every module
    at once): the same findings, file by file."""
    ref = {Path(r.path).relative_to(FIXTURES): r
           for r in ref_analyze_paths([FIXTURES], COPIED_PACKS)}
    port = {Path(r.path).relative_to(RELAID): r
            for r in analyze_paths([RELAID], COPIED_PACKS)}
    assert sorted(map(_port_rel, ref)) == sorted(port)
    total = 0
    for rel, r in ref.items():
        p = port[_port_rel(rel)]
        assert _norm(p.findings, RELAID) == _norm(r.findings, FIXTURES), rel
        total += len(r.findings)
    assert total > 20


# ---------------------------------------------------------------------------
# the reference's analysis test modules, run against the port
# ---------------------------------------------------------------------------

_FIXTURE_ROOT = 'Path(__file__).resolve().parent / "fixtures" / "analysis"'


def _port_test_module(name: str) -> types.ModuleType:
    """tests/<name>.py with ``nhd_tpu`` read as ``nhd_tpu_torch`` and the
    fixture root the re-laid tree."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    src = src.replace(_FIXTURE_ROOT, repr(RELAID.as_posix()).join(
        ("Path(", ")")))
    src = re.sub(r"\bnhd_tpu\b", "nhd_tpu_torch", src)
    mod = types.ModuleType(f"tests.port_of_{name}")
    mod.__file__ = str(path)
    exec(compile(src, f"{path} (against nhd_tpu_torch)", "exec"),
         mod.__dict__)
    return mod


def _export(name: str) -> int:
    """Bind every test and fixture of the ported module here, the tests
    under ``test_<module>__<test>`` so both suites' names stay apart."""
    mod = _port_test_module(name)
    n = 0
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and callable(obj):
            globals()[f"test_{name[5:]}__{attr[5:]}"] = obj
            n += 1
        elif getattr(obj, "_fixture_function_marker", None) is not None \
                or type(obj).__name__ == "FixtureFunctionDefinition":
            globals()[attr] = obj
    return n


PORTED_CASES = {name: _export(name) for name in (
    "test_lockgraph", "test_race_analysis", "test_lint_regressions")}


def test_every_ported_module_brought_its_cases():
    assert PORTED_CASES == {"test_lockgraph": 10, "test_race_analysis": 12,
                            "test_lint_regressions": 9}


# ---------------------------------------------------------------------------
# torch-aimed NHD1xx: inline fixtures (EXPECT markers on flagged lines)
# ---------------------------------------------------------------------------

_EXPECT = re.compile(r"#\s*EXPECT\[([A-Z0-9,\s]+)\]")

TRACING_POS = '''
import ctypes
import time

import numpy as np
import torch

from nhd_tpu_torch.kernels import build


def step(x, y):
    if x > 0:  # EXPECT[NHD102]
        y = y + 1
    n = int(x)  # EXPECT[NHD101]
    z = np.asarray(y)  # EXPECT[NHD103]
    k = x.item()  # EXPECT[NHD101]
    assert x  # EXPECT[NHD102]
    return z + n + k


def capture(g, a, b):
    with torch.cuda.graph(g):
        out = step(a, b)
        t0 = time.perf_counter()  # EXPECT[NHD106]
        s = out.sum()
        while s:  # EXPECT[NHD102]
            break
        rows = s.tolist()  # EXPECT[NHD101]
    return out, t0, rows


def timed(a):
    t0 = time.time()  # EXPECT[NHD106]
    return a * 2, t0


def statics(data, cfg=[1, 2]):
    return data


graphed = torch.cuda.make_graphed_callables(timed, (None,))
graphed2 = torch.cuda.make_graphed_callables(statics, (None,))  # EXPECT[NHD105]


def per_call(path):
    return ctypes.CDLL(path)  # EXPECT[NHD104]


def per_call_graph():
    return torch.cuda.CUDAGraph()  # EXPECT[NHD104]


def per_iteration(names):
    for n in names:
        build.load(n)  # EXPECT[NHD104]
'''

TRACING_NEG = '''
import ctypes
import functools
import time

import numpy as np
import torch

_LIBS = {}
LIBC = ctypes.CDLL("libc.so.6")
GRAPH = torch.cuda.CUDAGraph()


def load(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(name)
    return lib


@functools.lru_cache(maxsize=None)
def graph_for(shape):
    return torch.cuda.CUDAGraph()


def host_code(x):
    # not captured: host coercions are the host's business
    if x > 0:
        return int(x), x.item()
    t0 = time.perf_counter()
    return np.asarray(x), t0


def capture(g, a):
    n = a.shape[0]
    with torch.cuda.graph(g):
        out = a * 2
        if n > 1:
            out = out + 1
    return out


def frozen(x, k=(1, 2)):
    return x * 2


graphed = torch.cuda.make_graphed_callables(frozen, (None,))
'''

HOSTSYNC_POS = '''
import numpy as np
import torch

from nhd_tpu_torch import kernels


def round_pull(dev, pods):
    out = dev.solve_ranked(pods, 64)
    arr = out.cpu()  # EXPECT[NHD107]
    host = out.to("cpu")  # EXPECT[NHD107]
    same = out.to(device=torch.device("cpu"))  # EXPECT[NHD107]
    v = out[0].item()  # EXPECT[NHD107]
    rows = out.tolist()  # EXPECT[NHD107]
    torch.cuda.synchronize()  # EXPECT[NHD107]
    return arr, host, same, v, rows


def kernel_pull(a, b):
    planes = kernels.solve_planes(a, b)
    n = int(planes.sum())  # EXPECT[NHD107]
    ev = torch.cuda.Event()
    ev.synchronize()  # EXPECT[NHD107]
    flat = planes.reshape(-1)
    got = flat.numpy()  # EXPECT[NHD107]
    return n, np.asarray(planes), got  # EXPECT[NHD107]
'''

HOSTSYNC_NEG = '''
import numpy as np
import torch


class HostPull:
    """The sanctioned flush: its waits are the round's one sync."""

    def __init__(self, t):
        self._host = t
        self._event = torch.cuda.Event()

    def numpy(self):
        self._event.synchronize()
        return self._host.cpu().numpy()


def flush(dev, pods):
    out = dev.solve_ranked(pods, 64)
    return HostPull(out).numpy()


def host_side(values):
    a = np.zeros(4)
    t = torch.zeros(4)
    u = torch.from_numpy(a)
    return a.tolist(), t.numpy(), t.tolist(), u.numpy()


def suppressed(dev):
    out = dev.solve_ranked(None, 1)
    # a deliberate, reasoned pull
    return out.cpu()  # nhdlint: ignore[NHD107]
'''

ENCODE_POS = '''
from nhd_tpu_torch.solver.encode import encode_cluster


def schedule(nodes, rounds):
    for _ in range(rounds):
        cluster = encode_cluster(nodes)  # EXPECT[NHD108]
    return cluster
'''

#: the port's one-shot oracle-parity surface, sanctioned by name
ENCODE_MATCHER = '''
from nhd_tpu_torch.solver.encode import encode_cluster


def find_nodes(nodes, reqs, now):
    return encode_cluster(nodes, now=now)


def other(nodes):
    return encode_cluster(nodes)  # EXPECT[NHD108]
'''


def _expected(src: str) -> set:
    out = set()
    for lineno, line in enumerate(src.splitlines(), start=1):
        m = _EXPECT.search(line)
        if m:
            out.update((r.strip(), lineno) for r in m.group(1).split(","))
    return out


@pytest.mark.parametrize("rel,src", [
    ("capture_pos.py", TRACING_POS),
    ("capture_neg.py", TRACING_NEG),
    ("solver/hostsync_pos.py", HOSTSYNC_POS),
    ("solver/hostsync_neg.py", HOSTSYNC_NEG),
    ("solver/encode_pos.py", ENCODE_POS),
    ("solver/matcher.py", ENCODE_MATCHER),
])
def test_tracing_pack_inline_fixtures(rel, src, tmp_path):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    report = analyze_file(path, ["tracing"])
    assert {(f.rule, f.line) for f in report.findings} == _expected(src)
    if rel.endswith("_pos.py"):
        assert report.findings
    if rel == "solver/hostsync_neg.py":
        assert report.suppressed == 1


def test_tracing_positives_cover_every_nhd1xx_rule():
    rules = {r for src in (TRACING_POS, HOSTSYNC_POS, ENCODE_POS)
             for r, _ in _expected(src)}
    assert rules == {f"NHD10{i}" for i in range(1, 9)}


def test_host_sync_outside_the_solver_is_out_of_scope(tmp_path):
    path = tmp_path / "scheduler_like.py"
    path.write_text(HOSTSYNC_POS)
    assert analyze_file(path, ["tracing"]).findings == []


# ---------------------------------------------------------------------------
# ABI-aimed NHD7xx: a consistent miniature of the port, then one mutation
# per case (old -> new in one file) and the finding it must produce
# ---------------------------------------------------------------------------

MINI = {
    "solver/kernel.py": '''
        import os

        from nhd_tpu_torch import kernels

        _MUTABLE = ("busy", "cpu_free")
        _STATIC = ("smt",)
        _ARG_ORDER = ("smt", "busy", "cpu_free")
        _POD_ARG_ORDER = ("dem", "hp")

        STREAM = os.environ.get("NHD_STREAM_X", "0")


        def padded_args(cluster, pods):
            return [getattr(cluster, n) for n in _ARG_ORDER] + [
                getattr(pods, n) for n in _POD_ARG_ORDER]


        def node_block(cluster, pods):
            host = padded_args(cluster, pods)
            return host[: len(_ARG_ORDER)], host[len(_ARG_ORDER):]


        def plane_args(node, pod):
            a = dict(zip(_ARG_ORDER, node))
            p = dict(zip(_POD_ARG_ORDER, pod))
            return (a["smt"], a["busy"], a["cpu_free"], p["dem"])


        def solve(node, pod):
            return kernels.solve_planes(*plane_args(node, pod))
    ''',
    "solver/encode.py": '''
        DELTA_FIELDS = ("smt", "busy", "cpu_free")
    ''',
    "solver/combos.py": '''
        def get_tables(G, U, K):
            return (G, U, K)
    ''',
    "solver/aot.py": '''
        import hashlib
        import os
        from pathlib import Path


        def program_fingerprint():
            h = hashlib.sha256()
            here = Path(__file__).resolve().parent
            for name in ("kernel.py", "combos.py"):
                h.update((here / name).read_bytes())
            return h.hexdigest()


        def cache_dir():
            return os.environ.get("NHDC_CACHE", "/nowhere")
    ''',
    "solver/speculate.py": '''
        import numpy as np
        import torch

        from nhd_tpu_torch import kernels


        def to_device(a, device):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device, copy=True)


        def claim(cluster, plan, idx, rows):
            status = to_device(cluster.busy, "cpu")
            kernels.spec_fill(plan, status)
            busy = to_device(cluster.busy, "cpu")
            busy.index_copy_(0, idx, rows)
            return busy
    ''',
    "kernels/abi.py": '''
        ABI = {
            "solve_planes": KernelABI(
                "nhd_solve_planes",
                (
                    _a("smt", "bool", "N"),
                    _a("busy", "bool", "N"),
                    _a("cpu_free", "int32", "N U"),
                    _a("dem", "int32", "T"),
                    _a("out", "int32", "T N", out=True),
                ),
                ("T", "N", "U"),
            ),
            "spec_fill": KernelABI(
                "nhd_spec_fill",
                (
                    _a("plan", "int32", "PLAN N"),
                    _io("status", "bool", "N"),
                ),
                ("N", "handle"),
            ),
        }

        WIDE = ("handle",)

        HELPERS = {
            "graph_while": (
                HelperEntry("nhd_graph_while_open",
                            (("capture", "ptr"), ("handle", "u64"),
                             ("body", "ptr"), ("device", "int"))),
            ),
        }
    ''',
    "kernels/solve_planes.cu": '''
        extern "C" int nhd_solve_planes(
            const void* smt, const void* busy, const void* cpu_free,
            const void* dem, void* out,
            int T, int N, int U, int device, void* stream)
        {
            return 0;
        }
    ''',
    "kernels/spec_fill.cu": '''
        extern "C" int nhd_spec_fill(
            const void* plan, void* status, int N, unsigned long long handle,
            int device, void* stream)
        {
            return 0;
        }
    ''',
    "kernels/graph_while.cu": '''
        extern "C" int nhd_graph_while_open(
            void* capture, unsigned long long handle, void* body, int device)
        {
            return 0;
        }
    ''',
    "kernels/reference.py": '''
        def solve_planes(smt, busy, cpu_free, dem, *, node_base=0):
            return smt


        def spec_fill(plan, status):
            return None
    ''',
    "kernels/build.py": '''
        import hashlib
        from pathlib import Path

        from nhd_tpu_torch.kernels.abi import ABI

        _DIR = Path(__file__).resolve().parent


        def source_path(name):
            return _DIR / f"{name}.cu"


        def fingerprint(name):
            h = hashlib.sha1(source_path(name).read_bytes())
            h.update((_DIR / "abi.py").read_bytes())
            return h.hexdigest()
    ''',
    "config/knobs.py": '''
        KNOBS = (
            Knob("NHD_STREAM_X", "0", "a shared knob"),
        )
    ''',
    "config/port_knobs.py": '''
        KNOBS = (
            Knob("NHDC_CACHE", "`_build`", "the port's own knob"),
        )
    ''',
}

#: (case, file, old, new, rule, words of its message)
MUTATIONS = [
    ("key-ref", "solver/kernel.py", 'a["cpu_free"], p["dem"]',
     'a["cpu_fre"], p["dem"]', "NHD701", "KeyError"),
    ("block-literal", "solver/kernel.py", "host[: len(_ARG_ORDER)]",
     "host[:2]", "NHD701", "literal 2"),
    ("block-wrong-tuple", "solver/kernel.py", "host[len(_ARG_ORDER):]",
     "host[len(_POD_ARG_ORDER):]", "NHD701", "len(_POD_ARG_ORDER)"),
    ("delta-order", "solver/encode.py", '("smt", "busy", "cpu_free")',
     '("busy", "smt", "cpu_free")', "NHD702", "DELTA_FIELDS order"),
    ("cu-missing-pointer", "kernels/solve_planes.cu",
     "const void* dem, void* out", "void* out", "NHD701", "'dem'"),
    ("cu-swapped-pointers", "kernels/solve_planes.cu",
     "const void* smt, const void* busy", "const void* busy, const void* smt",
     "NHD702", "position 0"),
    ("cu-appended-int", "kernels/solve_planes.cu", "int U, int device",
     "int U, int node_base, int device", "NHD701", "'node_base'"),
    ("cu-entry-renamed", "kernels/spec_fill.cu", "nhd_spec_fill(",
     "nhd_spec_fill2(", "NHD701", "no extern"),
    ("cu-wide-size-as-int", "kernels/spec_fill.cu",
     "unsigned long long handle", "int handle", "NHD701", "64-bit"),
    ("abi-wide-size-unlisted", "kernels/abi.py", 'WIDE = ("handle",)',
     "WIDE = ()", "NHD701", "an int"),
    ("helper-swapped-pointers", "kernels/graph_while.cu",
     "void* capture, unsigned long long handle, void* body",
     "void* body, unsigned long long handle, void* capture", "NHD702",
     "position 0"),
    ("helper-kind", "kernels/graph_while.cu", "unsigned long long handle",
     "int handle", "NHD701", "binds it as u64"),
    ("helper-entry-renamed", "kernels/graph_while.cu", "nhd_graph_while_open(",
     "nhd_graph_while_opn(", "NHD701", "no extern"),
    ("plain-order", "kernels/reference.py", "def solve_planes(smt, busy,",
     "def solve_planes(busy, smt,", "NHD702", "plain version"),
    ("plain-missing", "kernels/reference.py", "def spec_fill(plan, status)",
     "def spec_fill(plan)", "NHD701", "'status'"),
    ("call-order", "solver/kernel.py", 'return (a["smt"], a["busy"],',
     'return (a["busy"], a["smt"],', "NHD702", "position 0"),
    ("call-short", "solver/kernel.py", ', p["dem"])', ")", "NHD701",
     "gets 3 tensors"),
    ("program-fingerprint", "solver/aot.py", '("kernel.py", "combos.py")',
     '("kernel.py",)', "NHD703", "'combos'"),
    ("library-fingerprint-abi", "kernels/build.py",
     '    h.update((_DIR / "abi.py").read_bytes())\n', "", "NHD703",
     "ABI table"),
    ("library-fingerprint-source", "kernels/build.py",
     "hashlib.sha1(source_path(name).read_bytes())", 'hashlib.sha1(b"")',
     "NHD703", ".cu source"),
    ("host-alias-kernel", "solver/speculate.py",
     'status = to_device(cluster.busy, "cpu")',
     "status = torch.from_numpy(cluster.busy)", "NHD710", "spec_fill"),
    ("host-alias-index-copy", "solver/speculate.py",
     'busy = to_device(cluster.busy, "cpu")',
     "busy = torch.as_tensor(cluster.busy).view(-1)", "NHD710",
     "index_copy_"),
    ("shared-knob", "solver/kernel.py", '"NHD_STREAM_X"', '"NHD_STREAM_Y"',
     "NHD720", "knobs.py"),
    ("port-knob", "solver/aot.py", '"NHDC_CACHE"', '"NHDC_CACHE_DIR"',
     "NHD720", "port_knobs.py"),
]


def _mini(tmp_path, case=None):
    root = tmp_path / "mini"
    for rel, text in MINI.items():
        text = textwrap.dedent(text).lstrip()
        if case is not None and rel == case[1]:
            assert text.count(case[2]) == 1, case
            text = text.replace(case[2], case[3])
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return [f for r in analyze_paths([root], ["contract"]) for f in r.findings]


def test_contract_miniature_is_consistent(tmp_path):
    assert _mini(tmp_path) == []


@pytest.mark.parametrize("case", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_contract_mutation_is_caught(case, tmp_path):
    found = _mini(tmp_path, case)
    rule, words = case[4], case[5]
    assert [f.rule for f in found] == [rule], found
    assert words in found[0].message, found[0].message


def test_contract_positives_cover_every_nhd7xx_rule():
    assert {m[4] for m in MUTATIONS} == {
        "NHD701", "NHD702", "NHD703", "NHD710", "NHD720"}


def test_contract_model_reads_the_live_abi():
    """The port's own tree, as the pack sees it: every kernel's row, its
    .cu entry and plain version, both fingerprints and both
    registries."""
    from nhd_tpu_torch.analysis.contracts import build_model
    from nhd_tpu_torch.analysis.core import _load_module, iter_py_files
    from nhd_tpu_torch.kernels.abi import ABI

    modules = [m for m in (_load_module(p)[1] for p in iter_py_files([PORT]))
               if m is not None]
    model = build_model(modules)
    assert set(model.abi_rows) == set(ABI) == set(model.plain_sigs)
    for name, row in model.abi_rows.items():
        assert row.entry == ABI[name].entry
        assert row.inputs == tuple(a.name for a in ABI[name].inputs)
        assert row.sizes == ABI[name].sizes
    assert model.abi_rows["spec_apply"].inplace
    from nhd_tpu_torch.kernels.abi import HELPERS, WIDE

    assert model.wide == WIDE
    assert [(h.source, h.entry, h.params) for h in model.helper_rows] == [
        (src, e.entry, e.params) for src, es in HELPERS.items() for e in es]
    sites = {Path(s.path).name: s for s in model.fingerprint_sites}
    assert set(sites["aot.py"].hashed) == {"kernel", "combos"}
    assert sites["build.py"].library and sites["build.py"].sources
    assert {Path(r.path).name for r in model.registries} == {
        "knobs.py", "port_knobs.py"}
    # every kernel is called; the other ``kernels.`` calls are the WHILE
    # node's helpers and the count of its passes
    assert {c.kernel for c in model.kernel_calls} == set(ABI) | {
        "while_handle", "while_open", "while_close", "count_passes"}


# ---------------------------------------------------------------------------
# the live tree and the repairs its first run asked for
# ---------------------------------------------------------------------------

def test_live_port_tree_is_clean_without_jax(tmp_path):
    """``python -m nhd_tpu_torch.analysis nhd_tpu_torch`` with no
    baseline, in a fresh interpreter where ``import jax`` fails."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['nhdlint', 'nhd_tpu_torch', '--no-baseline']\n"
        "runpy.run_module('nhd_tpu_torch.analysis', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=240, env=subprocess_env(),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "clean — 0 finding(s)" in proc.stdout
    assert "0 baselined" in proc.stdout


def test_intentional_sites_carry_their_suppressions():
    """aot.py's metadata stamp (NHD402, as the reference suppresses it),
    and the sync and library-open sites the port keeps on purpose."""
    aot = analyze_file(PORT / "solver" / "aot.py")
    assert aot.findings == [] and aot.suppressed >= 3
    line = next(ln for ln in (PORT / "solver" / "aot.py").read_text()
                .splitlines() if '"created_unix": time.time()' in ln)
    assert "nhdlint: ignore[NHD402]" in line
    for rel in ("solver/kernel.py", "solver/guard.py", "kernels/build.py",
                "native/__init__.py"):
        report = analyze_file(PORT / rel)
        assert report.findings == [] and report.suppressed >= 1, rel


def test_matcher_find_nodes_is_the_sanctioned_encode():
    from nhd_tpu_torch.analysis.rules_tracing import _ENCODE_SANCTIONED

    assert "matcher:find_nodes" in _ENCODE_SANCTIONED
    report = analyze_file(PORT / "solver" / "matcher.py", ["tracing"])
    assert report.findings == [] and report.suppressed == 5


def test_port_knob_registry_holds_the_port_knobs():
    from nhd_tpu_torch.config import knobs, port_knobs

    names = port_knobs.registered_names()
    assert "NHDC_AOT_DIR" in names
    assert all(n.startswith("NHDC_") for n in names)
    assert not names & knobs.registered_names()
    reads = set()
    for path in PORT.rglob("*.py"):
        reads.update(re.findall(r"environ\.get\(\s*\"(NHDC_\w+)\"",
                                path.read_text()))
    assert reads and reads <= names


def test_nvcc_wait_is_bounded(tmp_path, monkeypatch):
    """A compiler that hangs no longer holds the build lock forever: past
    NVCC_TIMEOUT_S the process is killed and the build raises."""
    from nhd_tpu_torch.kernels import build

    pids = tmp_path / "pids"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo $$ >> {pids}\n"
        "exec sleep 60\n"
    )
    fake.chmod(0o755)
    monkeypatch.setenv("NHDC_AOT_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "NVCC_TIMEOUT_S", 0.3)
    with pytest.raises(RuntimeError, match="killed after 0.3 s"):
        build.build_all()
    started = [int(p) for p in pids.read_text().split()]
    assert len(started) == len(build.SOURCES)
    for pid in started:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert not list((tmp_path / "cache").glob("*.so"))
