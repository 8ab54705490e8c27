"""Census of the port's coverage of the JAX package.

Every ``*.py`` / ``*.cc`` file of ``dist_dqn_tpu/`` has a twin at the same
relative path in ``dist_dqn_tpu_torch/``, and every public top-level
function, class and constant (an upper-case name) and every public method
of a JAX module that has a twin is defined somewhere in the port: a
top-level name of any port module, or a method of a port class of the same
name. A file or name that has no twin sits on a list below with a one-line
reason, and an entry goes stale, and fails the census, once its file or
name has a twin or is gone from the JAX package. Both trees are read with
``ast``; neither package is imported.

The bite cases run the census over synthetic trees under ``tmp_path``: a
missing twin and each kind of stale entry must be reported.
"""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "dist_dqn_tpu", "dist_dqn_tpu_torch"

#: JAX files with no twin at the same path in the port, and why.
FILES_WITHOUT_TWIN = {
    "ops/pallas_sampler.py":
        "the Pallas sampler kernel, ported as csrc/stratified_sample.cu "
        "with its wrapper and plain version in ops/sampler.py",
    "utils/compat.py":
        "resolves JAX's spellings of shard_map; the port's collectives "
        "live in parallel/mesh.py and parallel/distributed.py, which its "
        "mesh-axis check names",
    "utils/donation.py":
        "reads XLA's buffer-alias table; the port updates in place, and "
        "its donation check (analysis/plugins/donation.py) guards that",
}

#: Public names of JAX modules with a twin that the port does not define,
#: by JAX module, and why.
NAMES_WITHOUT_TWIN = {
    "agents/dqn.py": {
        "make_scan_train":
            "inlined: actors/learner_ranks.py make_scan_step scans the "
            "service's train step",
    },
    "analysis/plugins/donation.py": {
        "RATIONALE": "JAX's comment regex; the port's check passes "
                     "RATIONALE_TAG to core.has_rationale",
    },
    "analysis/plugins/mesh_axis.py": {
        "AXIS_IN_CALL": "a shard_map axis spec; the port's check matches "
                        "torch.distributed calls (COLLECTIVE)",
        "COMPAT_MODULE": "utils/compat.py, which the port lacks; the "
                         "port's check names SANCTIONED modules",
        "DIRECT": "JAX's direct shard_map spellings; the port's check "
                  "matches COLLECTIVE outside SANCTIONED",
        "RATIONALE": "JAX's comment regex; the port's check passes "
                     "RATIONALE_TAG to core.has_rationale",
    },
    "analysis/plugins/program_registry.py": {
        "RATIONALE": "JAX's comment regex; the port's check passes "
                     "RATIONALE_TAG to core.has_rationale",
    },
    "envs/__init__.py": {
        "make_jax_env": "builds the JAX envs; the port's envs.make_env "
                        "builds their TorchEnv twins",
    },
    "envs/base.py": {
        "JaxEnv": "the JAX env interface; the port's is envs/base.py "
                  "TorchEnv",
        "JaxEnv.reset": "TorchEnv.reset, on explicit draws",
        "JaxEnv.env_step": "TorchEnv.env_step, on explicit draws",
        "JaxEnv.step": "one env's auto-reset step under vmap; "
                       "TorchEnv.v_step resets the batch's done lanes",
        "JaxEnv.v_reset": "TorchEnv.v_reset (num_envs, generator)",
        "JaxEnv.v_step": "TorchEnv.v_step (state, action, generator)",
    },
    "loop_common.py": {
        "make_rng_splitter": "threefry key splits; the port's loops draw "
                             "from loop_common.generators / "
                             "rank_generators",
        "pallas_routing": "Pallas or its interpreter; the port's "
                          "loop_common.kernel_routing picks the CUDA "
                          "kernel on the card",
        "reduce_chunk_metrics": "inlined in loop_common.chunk_metrics "
                                "(one all-reduce under a mesh)",
        "ring_obs_example": "refuses a multi-leaf obs under flat_storage; "
                            "every port env emits one tensor "
                            "(tests/test_torch_envs.py), and the loops "
                            "take flatten(obs)[0] (flat_obs_codecs)",
    },
    "parallel/learner.py": {
        "replicated_device_views": "zero-copy views of a JAX replica; "
                                   "each host-replay rank casts its own "
                                   "actor snapshot "
                                   "(loop_common.make_actor_param_cast)",
    },
    "population.py": {
        "stacked_members": "unused in the JAX package; the port reads a "
                           "population's M from its config",
    },
    "utils/flops.py": {
        "compiled_flops": "XLA's cost analysis; the port counts FLOPs "
                          "with utils/flops.py census",
        "compiled_bytes": "XLA's cost analysis; the port counts bytes "
                          "with utils/flops.py census",
    },
    "utils/sizing.py": {
        "grad_step_flops_estimate": "the v5e model's FLOPs per grad "
                                    "step; the port charges measured "
                                    "seconds (GRAD_STEP_S and kin)",
        "ACHIEVED_FLOPS": "the v5e's FLOP rate; the port charges "
                          "measured seconds per grad step",
        "DISPATCH_S": "the v5e's dispatch round trip; the port charges "
                      "ITER_S per iteration",
        "HBM_CAPACITY_BYTES": "the v5e's HBM; the port reads the card's "
                              "(device_memory_bytes)",
        "HBM_REFUSE_BYTES": "the v5e's gate; the port refuses at "
                            "HBM_REFUSE_FRACTION of the card's memory",
        "RING_PAD_FLAT": "XLA's TPU tile padding; the port's rings are "
                         "unpadded (predict_fused_hbm_bytes)",
        "RING_PAD_TILED": "XLA's TPU tile padding; the port's rings are "
                          "unpadded (predict_fused_hbm_bytes)",
    },
}

_CONSTANT = re.compile(r"[A-Z][A-Z0-9_]*\Z")


def _source_files(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.suffix in (".py", ".cc") and "__pycache__" not in p.parts}


def _top_level(body):
    """Statements at module level, including those under if / try / with."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for block in ("body", "orelse", "finalbody"):
                yield from _top_level(getattr(node, block, []))
            for handler in getattr(node, "handlers", []):
                yield from _top_level(handler.body)


def _assigned(node) -> list:
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target] if isinstance(node, ast.AnnAssign) else [])
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _defined(path: Path, public_only: bool) -> set:
    """Top-level functions, classes and assigned names of a module, and
    ``Class.method`` for each method. With ``public_only``: no name with a
    leading underscore, and of the assigned names only constants."""
    names = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if public_only and node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not (public_only and m.name.startswith("_"))}
        for name in _assigned(node):
            if not public_only or _CONSTANT.match(name):
                names.add(name)
    return names


def census(jax_root: Path, port_root: Path, files_without_twin: dict,
           names_without_twin: dict) -> list:
    """Every problem the census finds, one line each (empty: the port
    covers the JAX package as the lists say)."""
    problems = []
    jax_files, port_files = _source_files(jax_root), _source_files(port_root)
    for rel in sorted(jax_files - port_files):
        if rel not in files_without_twin:
            problems.append(f"{rel}: no twin in the port and not listed")
    for rel, reason in sorted(files_without_twin.items()):
        if not reason.strip():
            problems.append(f"{rel}: listed without a reason")
        if rel not in jax_files:
            problems.append(f"{rel}: stale file entry, gone from JAX")
        elif rel in port_files:
            problems.append(f"{rel}: stale file entry, the port has a twin")
    port_names = set()
    for rel in port_files:
        if rel.endswith(".py"):
            port_names |= _defined(port_root / rel, public_only=False)
    twinned = sorted(r for r in jax_files & port_files if r.endswith(".py"))
    jax_names = {rel: _defined(jax_root / rel, public_only=True)
                 for rel in twinned}
    for rel in twinned:
        listed = names_without_twin.get(rel, {})
        for name in sorted(jax_names[rel] - port_names):
            if name not in listed:
                problems.append(f"{rel}: {name} has no twin in the port "
                                f"and is not listed")
    for rel, listed in sorted(names_without_twin.items()):
        for name, reason in sorted(listed.items()):
            if not reason.strip():
                problems.append(f"{rel}: {name} listed without a reason")
            if name not in jax_names.get(rel, ()):
                problems.append(f"{rel}: stale name entry {name}, gone "
                                f"from JAX's twinned module")
            elif name in port_names:
                problems.append(f"{rel}: stale name entry {name}, the "
                                f"port defines it")
    return problems


def test_port_covers_the_jax_package():
    assert census(REPO / JAX_PKG, REPO / PORT_PKG, FILES_WITHOUT_TWIN,
                  NAMES_WITHOUT_TWIN) == []


def test_census_sees_the_helpers_this_slice_ported():
    """The three JAX helpers whose twins closed the census are found in
    the port under their JAX names."""
    port = REPO / PORT_PKG
    assert "ShmSlotRing.push_wait" in _defined(port / "ingest/shm_ring.py",
                                               public_only=True)
    assert {"n_step_from_rollout", "q_learning_error"} <= _defined(
        port / "ops/losses.py", public_only=True)


def _write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


JAX_MODULE = '''
LIMIT = 3
Array = object
_private = 1


def helper():
    pass


def _hidden():
    pass


class Ring:
    def push(self):
        pass

    def _claim(self):
        pass


try:
    def optional():
        pass
except ImportError:
    pass
'''

PORT_MODULE = '''
LIMIT = 3


def helper():
    pass


class Ring:
    def push(self):
        pass
'''


def _trees(tmp_path: Path):
    jax_root, port_root = tmp_path / "jax_pkg", tmp_path / "port_pkg"
    _write(jax_root, "mod.py", JAX_MODULE)
    _write(jax_root, "_native/tree.cc", "int f();\n")
    _write(jax_root, "kernel.py", "def kernel():\n    pass\n")
    _write(port_root, "mod.py", PORT_MODULE + "\n\ndef optional():\n"
           "    pass\n")
    _write(port_root, "_native/tree.cc", "int f();\n")
    return jax_root, port_root


_FILES = {"kernel.py": "ported as a CUDA kernel"}

# (what the case breaks, the lists it runs with, a file to add to a tree,
# the problem the census must report).
BITES = {
    "clean": (_FILES, {}, None, None),
    "missing_file": ({}, {}, None,
                     "kernel.py: no twin in the port and not listed"),
    "missing_cc": (_FILES, {}, ("jax", "_native/extra.cc", "int g();\n"),
                   "_native/extra.cc: no twin in the port and not listed"),
    "file_entry_twinned": (_FILES, {}, ("port", "kernel.py",
                                        "def kernel():\n    pass\n"),
                           "kernel.py: stale file entry, the port has a "
                           "twin"),
    "file_entry_gone": ({**_FILES, "gone.py": "removed"}, {}, None,
                        "gone.py: stale file entry, gone from JAX"),
    "file_reason_empty": ({"kernel.py": " "}, {}, None,
                          "kernel.py: listed without a reason"),
    "missing_function": (_FILES, {}, ("jax", "mod.py",
                                      JAX_MODULE + "\ndef extra():\n"
                                      "    pass\n"),
                         "mod.py: extra has no twin in the port and is "
                         "not listed"),
    "missing_method": (_FILES, {}, ("jax", "mod.py", JAX_MODULE.replace(
        "    def _claim", "    def wait(self):\n        pass\n\n"
                          "    def _claim")),
                       "mod.py: Ring.wait has no twin in the port and is "
                       "not listed"),
    "missing_constant": (_FILES, {}, ("jax", "mod.py",
                                      JAX_MODULE + "\nPEAK = 1.0\n"),
                         "mod.py: PEAK has no twin in the port and is not "
                         "listed"),
    "name_entry_twinned": (_FILES, {"mod.py": {"helper": "inlined"}}, None,
                           "mod.py: stale name entry helper, the port "
                           "defines it"),
    "name_entry_gone": (_FILES, {"mod.py": {"vanished": "JAX-only"}}, None,
                        "mod.py: stale name entry vanished, gone from "
                        "JAX's twinned module"),
    "name_reason_empty": (_FILES, {"mod.py": {"PEAK": ""}},
                          ("jax", "mod.py", JAX_MODULE + "\nPEAK = 1.0\n"),
                          "mod.py: PEAK listed without a reason"),
}


@pytest.mark.parametrize("case", sorted(BITES))
def test_census_bites_on_synthetic_trees(tmp_path, case):
    files, names, extra, want = BITES[case]
    jax_root, port_root = _trees(tmp_path)
    if extra is not None:
        side, rel, text = extra
        _write(jax_root if side == "jax" else port_root, rel, text)
    problems = census(jax_root, port_root, files, names)
    assert problems == ([] if want is None else [want])
