"""Check ``mesh-axis``: the port's collectives resolve through its mesh
modules and name their process group, the mesh axis (or carry a
rationale).

Torch counterpart of ``dist_dqn_tpu/analysis/plugins/mesh_axis.py``.
The port has no ``shard_map`` or ``pjit``: its ``dp`` axis is a
``torch.distributed`` process group (``parallel/mesh.py`` ``Mesh.group``)
and its cross-rank traffic is ``torch.distributed`` collectives. Two
rules:

1. The collectives — ``all_reduce*``, ``broadcast*``, ``all_gather*``,
   ``reduce_scatter*``, ``all_to_all*``, ``reduce``, ``gather``,
   ``scatter``, ``barrier``/``monitored_barrier``, ``send``/``recv``
   (and ``isend``/``irecv``) and every ``*_object*`` collective — are
   called only in ``parallel/mesh.py`` and ``parallel/distributed.py``,
   which play ``utils/compat.py``'s role as the one sanctioned place.
   Every other module reaches the group through ``Mesh`` (``psum``,
   ``pmean``, ``pmax``, ``gather``, ``barrier``, ``broadcast_``), so a
   change of backend, packing or group layout lands in one file.
2. Every collective call, wherever it is, names its axis: a ``group=``
   keyword in the call, so a reader at the call site can always answer
   "which ranks does this reduce over" (a call on the default group
   relies on whoever initialized the process).

Either rule yields to a ``# mesh-axis: <reason>`` comment on the call's
line or within three lines above it.

A call is a collective when its function resolves to
``torch.distributed``: ``dist.all_reduce(...)`` in a file that binds
``dist`` to the module (``import torch.distributed as dist``, ``from
torch import distributed as dist``), the spelled-out
``torch.distributed.all_reduce(...)``, or a bare name imported from
``torch.distributed``. Other receivers (``mesh.barrier()``, a socket's
``send``) never count.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, has_rationale)
from dist_dqn_tpu_torch.analysis.registry import register

SCAN_ROOTS = ("dist_dqn_tpu_torch", "chip_smoke.py")
#: The modules allowed to call the collectives (rule 1).
SANCTIONED = ("dist_dqn_tpu_torch/parallel/mesh.py",
              "dist_dqn_tpu_torch/parallel/distributed.py")

#: ``torch.distributed`` functions that are collectives.
COLLECTIVE = re.compile(
    r"(?:all_reduce\w*|broadcast\w*|all_gather\w*|reduce_scatter\w*|"
    r"all_to_all\w*|reduce|gather|scatter|barrier|monitored_barrier|"
    r"i?send|i?recv|\w*_object\w*)\Z")
RATIONALE_TAG = "mesh-axis:"


def _module_aliases(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """(names bound to the ``torch.distributed`` module, {bare name ->
    function} imported from it), anywhere in the file."""
    modules: Set[str] = set()
    bare: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        modules.add(a.asname or a.name)
            elif node.module == "torch.distributed":
                for a in node.names:
                    bare[a.asname or a.name] = a.name
    return modules, bare


def _collective_name(func: ast.expr, modules: Set[str],
                     bare: Dict[str, str]) -> str:
    """The collective's name when ``func`` resolves to one, else ""."""
    name = ""
    if isinstance(func, ast.Attribute):
        recv = func.value
        if isinstance(recv, ast.Name) and recv.id in modules:
            name = func.attr
        elif isinstance(recv, ast.Attribute) \
                and recv.attr == "distributed" \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "torch":
            name = func.attr
    elif isinstance(func, ast.Name) and func.id in bare:
        name = bare[func.id]
    return name if COLLECTIVE.match(name) else ""


def collective_sites(ctx: AnalysisContext
                     ) -> List[Tuple[str, int, str, bool]]:
    """Every collective call in the scan roots: (relpath, lineno, name,
    names its group)."""
    out: List[Tuple[str, int, str, bool]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if rel.startswith("dist_dqn_tpu_torch/analysis/"):
            continue  # the lint layer DEFINES the patterns it hunts
        try:
            tree = ctx.tree(rel)
        except SyntaxError:
            continue  # reported by scan()
        modules, bare = _module_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _collective_name(node.func, modules, bare)
            if name:
                out.append((rel, node.lineno, name,
                            any(k.arg == "group" for k in node.keywords)))
    return out


def scan(repo_root: Path, ctx: AnalysisContext = None
         ) -> List[Tuple[str, int, str]]:
    """[(relpath, lineno, message), ...] for violating sites.
    Pass the run's shared ``ctx`` to reuse its parse cache."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    failures: List[Tuple[str, int, str]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        try:
            ctx.tree(rel)
        except SyntaxError as e:
            failures.append((rel, e.lineno or 0, "<unparseable>"))
    for rel, lineno, name, has_group in collective_sites(ctx):
        # span 4: the call's line and the three above it.
        if has_rationale(ctx.lines(rel), lineno, RATIONALE_TAG, span=4):
            continue
        if rel not in SANCTIONED:
            failures.append(
                (rel, lineno,
                 f"direct torch.distributed.{name} outside "
                 "parallel/mesh.py and parallel/distributed.py — route "
                 "it through dist_dqn_tpu_torch.parallel.mesh.Mesh "
                 "(psum/pmean/pmax/gather/barrier/broadcast_)"))
        if not has_group:
            failures.append(
                (rel, lineno,
                 f"{name}(...) names no mesh axis — pass the axis's "
                 "process group as group= or put a '# mesh-axis: "
                 "<where the group comes from>' comment above it"))
    return failures


class MeshAxisCheck(Check):
    name = "mesh-axis"
    description = ("torch.distributed collectives resolve through "
                   "parallel/mesh.py or parallel/distributed.py and "
                   "every collective call names its group= (the mesh "
                   "axis) or carries a '# mesh-axis:' rationale")
    rationale_tag = RATIONALE_TAG

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, lineno, msg in scan(ctx.root, ctx=ctx):
            # Line-text key: stable across unrelated edits (the
            # baseline contract), distinct per site and rule.
            site = ctx.lines(rel)[lineno - 1].strip()[:80] \
                if lineno else ""
            rule = "direct" if msg.startswith("direct") else "axis"
            findings.append(self.finding(
                rel, lineno, msg, key=f"mesh:{rule}:{rel}:{site}"))
        return findings


register(MeshAxisCheck())
