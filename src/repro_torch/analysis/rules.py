"""The port's RPL lint rules: the torch meaning of each bug class of the
reference's rules (``repro/analysis/rules.py``). A rule keeps its number;
a dropped rule's number is never reused.

| rule   | the bug class in the port                                        |
| ------ | ---------------------------------------------------------------- |
| RPL001 | process-wide topology in library code: ``torch.cuda.device_     |
|        | count()`` (any ``device_count``/``local_device_count``) or      |
|        | ``dist.get_world_size()`` of the whole world (no group, ``None`` |
|        | or ``WORLD``). The port dispatches on the tensor's device or     |
|        | ``sharding.is_dtensor``; a site that means the whole world says  |
|        | why in a pragma                                                  |
| RPL002 | host randomness (``random.*``, ``np.random.*``) or a constant    |
|        | ``manual_seed`` inside a traced body (one draw for every client  |
|        | under ``vmap``, another draw when ``checkpoint`` recomputes),    |
|        | and a torch sampler with no ``generator=`` anywhere: it draws    |
|        | from the global generator, outside the explicit-generator chain  |
|        | that ``keytrace`` audits                                         |
| RPL003 | Python ``if``/``while``, ``float()``/``int()``/``bool()``,       |
|        | ``.item()``/``.tolist()`` on a batched tensor inside a           |
|        | ``torch.func.vmap`` body: vmap raises on data-dependent control  |
|        | flow (``grad`` and ``checkpoint`` run such code eagerly, so only |
|        | vmap bodies are checked; ``is None`` and shape tests are static) |
| RPL004 | ``.to(torch.bfloat16/float16)``, ``.half()``, ``.bfloat16()``    |
|        | before a ``torch.distributed`` reduction or gather in the same   |
|        | function (``api/collective.py``): partials cross in float32,     |
|        | with one downcast after                                          |
| RPL005 | a ``torch.distributed`` collective with no ``group=``: it        |
|        | silently runs over WORLD where a mesh dim's group was meant      |
|        | (the reference's unbound axis name)                              |
| RPL007 | a generator stream opened twice: two generators from the same    |
|        | seed expression (``lane_generator``, ``manual_seed``,            |
|        | ``set_state``, ``api/driver.py``'s ``_as_generator``) that both  |
|        | feed draws, in one scope or on every iteration of a loop         |
|        | (``keyflow``)                                                    |
| RPL008 | chain contamination: an auxiliary function (fault, checkpoint,   |
|        | telemetry, ...) draws from the generator it was handed or the    |
|        | round's generator instead of a private ``lane_generator`` lane   |
|        | (``faults/spec.py``): a zero-probability fault spec must leave   |
|        | the trajectory bit-identical                                     |
| RPL009 | salt collision: two ``lane_generator(seed, index, salt)`` sites  |
|        | whose salts resolve to the same integer (cross-module constants  |
|        | through the ``ProjectIndex``): the lanes are the same stream     |

Dropped:

* RPL006 (Pallas ``BlockSpec`` lane alignment and accumulating output
  blocks): the port has no Python block specs. Its kernels are CUDA C++,
  whose tiles are template constants of the sources, and the wrappers
  check shapes and groups at run time (``kernels/quantize_block.py``), so
  there is nothing in Python for a rule to read.

Each rule is ``fn(index, path) -> list[Finding]``. Suppression and pragma
handling live in ``linter.py``.
"""
from __future__ import annotations

import ast
import re
from typing import Callable

from .findings import Finding, Severity
from .keyflow import GeneratorFlow, TorchNamespace, generator_arg
from .modindex import ModuleIndex, dotted_name, last_component

# torch.distributed collectives -> the position of their ``group``
# argument (c10d's signatures; the functional collectives of
# ``torch.distributed._functional_collectives`` take it at the same
# place or earlier, and always pass it)
_COLLECTIVES = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_tensor": 2, "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "all_to_all": 2, "all_to_all_single": 4, "broadcast": 2, "reduce": 3,
    "gather": 3, "scatter": 3, "barrier": 0, "all_gather_object": 2,
    "broadcast_object_list": 2,
}
# the collectives that carry partials across ranks (RPL004)
_CROSSING = {"all_reduce", "all_gather", "all_gather_into_tensor",
             "all_gather_tensor", "reduce_scatter", "reduce_scatter_tensor",
             "all_to_all", "all_to_all_single", "reduce"}
_LOW_PRECISION = {"torch.bfloat16", "torch.float16", "torch.half"}
# attributes and methods of a tensor that vmap knows without its data
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "layout", "requires_grad", "dim", "numel", "stride",
                 "is_floating_point", "is_complex", "is_contiguous",
                 "element_size"}


def _finding(rule, path, node, msg, severity=Severity.ERROR) -> Finding:
    return Finding(rule=rule, path=path, line=node.lineno,
                   col=node.col_offset, message=msg, severity=severity)


def _collective(index: ModuleIndex, call: ast.Call):
    """The ``torch.distributed`` collective a call names, else None."""
    name = index.qualify(call.func) or ""
    comp = name.rsplit(".", 1)[-1]
    if name.startswith("torch.distributed.") and comp in _COLLECTIVES:
        return comp
    return None


# ---------------------------------------------------------------------------
# RPL001 — process-wide topology in library code
# ---------------------------------------------------------------------------

def rpl001(index: ModuleIndex, path: str) -> list:
    out = []
    for node in ast.walk(index.tree):
        if not isinstance(node, ast.Call):
            continue
        comp = last_component(node.func)
        if comp in ("device_count", "local_device_count"):
            out.append(_finding(
                "RPL001", path, node,
                f"process-wide {comp}() in library code: dispatch on the "
                f"tensor's device or DTensor placement (sharding."
                f"is_dtensor), not global device topology (the reference's "
                f"PR-4 bug class: leaves silently dropped off the kernel "
                f"path on multi-device hosts)"))
        elif comp == "get_world_size" and _whole_world(node):
            out.append(_finding(
                "RPL001", path, node,
                "get_world_size() of the whole process group in library "
                "code: take the size of the group the work runs over "
                "(mesh.get_group(dim)); where the whole world is meant, "
                "say why in a pragma"))
    return out


def _whole_world(call: ast.Call) -> bool:
    """The call's group is the whole world: none given, ``None``, or an
    expression whose last component is ``WORLD`` (``dist.group.WORLD``,
    ``GroupMember.WORLD``)."""
    group = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "group"), None)
    if group is None:
        return True
    if isinstance(group, ast.Constant) and group.value is None:
        return True
    return last_component(group) == "WORLD"


# ---------------------------------------------------------------------------
# RPL002 — host randomness in traced code; draws off the explicit chain
# ---------------------------------------------------------------------------

def rpl002(index: ModuleIndex, path: str) -> list:
    ns = TorchNamespace(index)
    out = []
    for node in ast.walk(index.tree):
        if not isinstance(node, ast.Call):
            continue
        sampler = ns.sampler_of(node)
        if sampler is not None and generator_arg(node) is None:
            out.append(_finding(
                "RPL002", path, node,
                f"'{sampler}' with no generator= draws from torch's global "
                f"generator: pass the generator of the chain (or a "
                f"lane_generator lane) so the draw replays from the run's "
                f"seed and keytrace audits it"))
            continue
        if not index.in_traced(node):
            continue
        name = dotted_name(node.func) or ""
        root = name.split(".", 1)[0]
        if (name.startswith(("np.random.", "numpy.random."))
                or root == "random"):
            out.append(_finding(
                "RPL002", path, node,
                f"host randomness '{name}' inside a traced function: under "
                f"vmap it is one draw for every client, and checkpoint's "
                f"recompute draws again: take a torch.Generator from the "
                f"caller"))
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.append(_finding(
                "RPL002", path, node,
                "constant manual_seed inside a traced function: every call "
                "re-derives the SAME stream: take a generator threaded "
                "through the caller instead"))
    return out


# ---------------------------------------------------------------------------
# RPL003 — data-dependent control flow in vmap bodies
# ---------------------------------------------------------------------------

def _refs_tainted(index: ModuleIndex, expr: ast.AST, tainted: set) -> bool:
    """Does ``expr`` read a tainted name OTHER than through a static
    attribute (``x.shape``, ``x.dim()``, ``len(x)``, ``isinstance(x, T)``)
    or an identity test (``x is None``)?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in tainted:
            parent = index.parents.get(node)
            if (isinstance(parent, ast.Attribute)
                    and parent.attr in _STATIC_ATTRS):
                continue
            if (isinstance(parent, ast.Call)
                    and last_component(parent.func) in ("len",
                                                        "isinstance")):
                continue
            if (isinstance(parent, ast.Compare)
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in parent.ops)):
                continue
            return True
    return False


def rpl003(index: ModuleIndex, path: str) -> list:
    out = []
    for node in ast.walk(index.tree):
        if index.traced_under(node, "vmap") is None:
            continue
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("item", "tolist")
                    and not node.args):
                out.append(_finding(
                    "RPL003", path, node,
                    f".{node.func.attr}() inside a vmap body: vmap raises on "
                    f"reading a batched tensor's value: keep it a tensor"))
                continue
            func = index.enclosing_function(node)
            tainted = index.tainted_params(func) if func else set()
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and len(node.args) == 1
                    and _refs_tainted(index, node.args[0], tainted)):
                out.append(_finding(
                    "RPL003", path, node,
                    f"{node.func.id}() on a batched tensor inside a vmap "
                    f"body: vmap raises on .item(): use a tensor cast "
                    f"(.to(dtype)) and keep it batched"))
        elif isinstance(node, (ast.If, ast.While)):
            func = index.enclosing_function(node)
            tainted = index.tainted_params(func) if func else set()
            if _refs_tainted(index, node.test, tainted):
                kw = "if" if isinstance(node, ast.If) else "while"
                out.append(_finding(
                    "RPL003", path, node,
                    f"Python `{kw}` on a batched tensor inside a vmap body: "
                    f"vmap raises on data-dependent control flow: use "
                    f"torch.where (shape/dtype/ndim tests and `is None` are "
                    f"fine and not flagged)"))
    return out


# ---------------------------------------------------------------------------
# RPL004 — downcast before the crossing collective
# ---------------------------------------------------------------------------

def _downcast(index: ModuleIndex, node: ast.Call) -> bool:
    func = node.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr in ("half", "bfloat16") and not node.args:
        return True
    if func.attr not in ("to", "type"):
        return False
    dtypes = list(node.args) + [kw.value for kw in node.keywords
                                if kw.arg == "dtype"]
    return any((index.qualify(d) or "") in _LOW_PRECISION for d in dtypes)


def rpl004(index: ModuleIndex, path: str) -> list:
    out = []
    for node in ast.walk(index.tree):
        if not (isinstance(node, ast.Call) and _downcast(index, node)):
            continue
        body = index.enclosing_def(node)
        if body is None:
            continue
        # "before the collective" = the collective starts at a later
        # source position, OR the downcast is nested inside the collective
        # call itself (all_reduce(x.to(torch.bfloat16))). A downcast of the
        # collective's result (funcol.all_reduce(...).to(...)) is the
        # sanctioned pattern and matches neither arm.
        later_collective = any(
            isinstance(n, ast.Call) and _collective(index, n) in _CROSSING
            and ((n.lineno, n.col_offset) > (node.lineno, node.col_offset)
                 or any(child is node for child in ast.walk(n)))
            for n in ast.walk(body))
        if later_collective:
            out.append(_finding(
                "RPL004", path, node,
                "low-precision downcast BEFORE a crossing collective in the "
                "same function: partials must cross the ranks in the "
                "accumulation dtype (float32) with ONE downcast after the "
                "reduction, or each rank's slice rounds on its own (the "
                "reference's PR-5 bf16 invariant)"))
    return out


# ---------------------------------------------------------------------------
# RPL005 — a collective with no group
# ---------------------------------------------------------------------------

def rpl005(index: ModuleIndex, path: str) -> list:
    out = []
    for node in ast.walk(index.tree):
        if not isinstance(node, ast.Call):
            continue
        comp = _collective(index, node)
        if comp is None:
            continue
        if len(node.args) > _COLLECTIVES[comp] \
                or any(kw.arg == "group" for kw in node.keywords):
            continue
        out.append(_finding(
            "RPL005", path, node,
            f"collective '{comp}' with no group runs over every rank of "
            f"the process group: on a mesh it belongs to a mesh dim's "
            f"group (mesh.get_group(dim)); name dist.group.WORLD where the "
            f"whole world is meant"))
    return out


# ---------------------------------------------------------------------------
# RPL007 — a generator stream opened twice (def-use pass in keyflow.py)
# ---------------------------------------------------------------------------

def rpl007(index: ModuleIndex, path: str) -> list:
    out = []
    for r in GeneratorFlow(index).run().replays:
        if r.first_node is r.node:
            how = (f"'{r.name}' is made again from the same seed on every "
                   f"iteration")
        else:
            how = (f"the draw by {r.first_fn} at line {r.first_node.lineno} "
                   f"(through '{r.first_name}') already drew this stream")
        out.append(_finding(
            "RPL007", path, r.node,
            f"generator replay: {r.fn} draws through '{r.name}' from a "
            f"stream opened twice: {how}: derive each generator from a "
            f"distinct seed (a lane_generator salt, the round index); "
            f"replayed draws correlate what the MM analysis needs "
            f"independent"))
    return out


# ---------------------------------------------------------------------------
# RPL008 — chain contamination (the chain drawn where a lane is owed)
# ---------------------------------------------------------------------------

_ROUND_GEN_RE = re.compile(
    r"^(gen|generator|key|chain|round_gen|k_round|round_key|k_wave|wave_key)$")
_AUX_FN_RE = re.compile(
    r"fault|corrupt|straggl|checkpoint|snapshot|telemetry|drill|kill|drop",
    re.IGNORECASE)


def _param_names(func) -> set:
    args = getattr(func, "args", None)
    if args is None:
        return set()
    names = {a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)}
    if args.vararg:
        names.add(args.vararg.arg)
    return names


def _lanes(func, ns: TorchNamespace) -> set:
    """Names ``func`` binds to a generator of its own (a lane): a
    ``lane_generator``, or a ``torch.Generator`` seeded or not (the
    ``_as_generator`` of ``api/driver.py``, of the round's key, is the
    chain itself)."""
    return {node.targets[0].id for node in ast.walk(func)
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and ns.creator_of(node.value) in ("default", "seed",
                                              "lane_generator")}


def rpl008(index: ModuleIndex, path: str) -> list:
    """Only functions whose NAME says they are auxiliary (fault /
    checkpoint / telemetry / ...) are checked: the chain's owner draws
    from the round's generator, an auxiliary draw never may. It takes a
    private ``lane_generator`` lane, so switching it off leaves the main
    trajectory bit-identical."""
    ns = TorchNamespace(index)
    out = []
    for node in ast.walk(index.tree):
        if not (isinstance(node, ast.Call) and ns.sampler_of(node)):
            continue
        gen = generator_arg(node)
        if not isinstance(gen, ast.Name):
            continue
        func = index.enclosing_def(node)
        if func is None or not _AUX_FN_RE.search(func.name):
            continue
        if not (gen.id in _param_names(func)
                or _ROUND_GEN_RE.match(gen.id)) \
                or gen.id in _lanes(func, ns):
            continue
        out.append(_finding(
            "RPL008", path, node,
            f"chain contamination: auxiliary '{func.name}' draws from "
            f"'{gen.id}': fault/checkpoint/telemetry draws take a private "
            f"lane (faults.spec.lane_generator(seed, index, salt)), never "
            f"the round's generator (a zero-probability auxiliary draw "
            f"must leave the main trajectory bit-identical)"))
    return out


# ---------------------------------------------------------------------------
# RPL009 — lane salt collisions (cross-module constants via ProjectIndex)
# ---------------------------------------------------------------------------

def rpl009(index: ModuleIndex, path: str) -> list:
    sites: dict = {}    # salt value -> [Call] in source order
    for node in ast.walk(index.tree):
        if not (isinstance(node, ast.Call)
                and last_component(node.func) == "lane_generator"):
            continue
        salt_node = node.args[2] if len(node.args) > 2 else None
        if salt_node is None:
            for kw in node.keywords:
                if kw.arg == "salt":
                    salt_node = kw.value
                    break
        if salt_node is None:
            continue
        val = index.resolve_int(salt_node)
        if val is not None:        # data-dependent salts: skip, not guess
            sites.setdefault(val, []).append(node)
    out = []
    for val, nodes in sorted(sites.items()):
        if len(nodes) < 2:
            continue
        nodes.sort(key=lambda n: (n.lineno, n.col_offset))
        first = nodes[0]
        for n in nodes[1:]:
            out.append(_finding(
                "RPL009", path, n,
                f"salt collision: lane salt {val:#x} is already used by the "
                f"lane_generator at line {first.lineno}: two lanes with the "
                f"same salt are the SAME stream at every (seed, index); "
                f"every reserved lane needs a distinct module-level "
                f"constant"))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

RULES: dict = {
    "RPL001": (rpl001, "process-wide device_count() / get_world_size() "
                       "with no group in library code"),
    "RPL002": (rpl002, "host randomness / constant manual_seed inside "
                       "traced code; a torch sampler with no generator="),
    "RPL003": (rpl003, "Python if/float()/.item() on batched tensors in "
                       "vmap bodies"),
    "RPL004": (rpl004, "low-precision downcast before a crossing "
                       "torch.distributed collective"),
    "RPL005": (rpl005, "torch.distributed collective with no group "
                       "(runs over WORLD)"),
    "RPL007": (rpl007, "generator replay: one stream opened twice and "
                       "drawn from both"),
    "RPL008": (rpl008, "chain contamination: aux draws from the round's "
                       "generator instead of a lane_generator lane"),
    "RPL009": (rpl009, "lane salt collision: two lane_generator sites "
                       "with the same integer salt"),
}

# rule ids the port does not keep, with the reason (never reused)
DROPPED: dict = {
    "RPL006": "Pallas BlockSpec alignment: the port's kernels are CUDA "
              "C++ with their tiles in the sources and run-time shape "
              "checks in the wrappers; no Python block spec to read",
}


def rule_table() -> str:
    lines = ["rule    description", "------  -----------"]
    for rid, (_, desc) in sorted(RULES.items()):
        lines.append(f"{rid}  {desc}")
    for rid, why in sorted(DROPPED.items()):
        lines.append(f"{rid}  (dropped) {why}")
    return "\n".join(lines)


def get_rules(names=None) -> dict:
    """Subset of RULES by id (all when ``names`` is None)."""
    if names is None:
        return dict(RULES)
    unknown = set(names) - set(RULES)
    if unknown:
        dropped = sorted(unknown & set(DROPPED))
        raise KeyError(f"unknown rule(s): {sorted(unknown)}"
                       + (f" ({', '.join(dropped)} dropped in the port)"
                          if dropped else ""))
    return {k: RULES[k] for k in names}


RuleFn = Callable[[ModuleIndex, str], list]
