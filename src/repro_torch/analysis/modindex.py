"""Per-module AST index shared by every lint rule of the port (the
counterpart of ``repro/analysis/modindex.py``).

One parse, one walk: parent links, the set of TRACED functions (bodies run
by a torch transform: ``torch.func.vmap``, ``grad``, ``grad_and_value``,
``jacrev``, ``jacfwd``, ``vjp``, ``jvp``, ``hessian``, ``functional_call``,
``torch.utils.checkpoint.checkpoint`` and ``torch.compile``, and the
``forward``/``backward`` of an ``autograd.Function`` subclass), which
transform traces each of them (RPL003 reads only ``vmap``'s), the
qualified name of a call through the module's imports
(``dist.all_reduce`` -> ``torch.distributed.all_reduce``), and
compile-time integers, across modules through a ``ProjectIndex``.

Everything here is a lexical heuristic: a function is "traced" when it is
decorated with a transform or passed by name, lambda or
``functools.partial`` as the traced argument of one, or is lexically
nested inside such a function. The transforms are matched by their
qualified name, which must lie under ``torch`` and not under
``torch.autograd`` (whose ``grad`` takes outputs, not a function), so
``re.compile`` or a module's own ``checkpoint`` is no transform. Rules
built on it aim at the port's real bug classes, not at soundness.
"""
from __future__ import annotations

import ast
from typing import Optional, Union

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# torch transforms that TRACE one of their arguments: final dotted
# component -> positional indices of the traced function argument(s)
_TRACING_CALLS = {
    "vmap": (0,), "grad": (0,), "grad_and_value": (0,), "jacrev": (0,),
    "jacfwd": (0,), "vjp": (0,), "jvp": (0,), "hessian": (0,),
    "functional_call": (0,), "checkpoint": (0,), "compile": (0,),
}

# the methods of an ``autograd.Function`` subclass that autograd runs
_FUNCTION_METHODS = {"forward", "backward", "setup_context", "jvp", "vmap"}
# parameters that hold no tensor in a traced method
_NOT_TENSORS = {"self", "cls", "ctx"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.func.vmap`` for the corresponding Attribute chain; None for
    anything that is not a pure Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_component(node: ast.AST) -> Optional[str]:
    name = dotted_name(node)
    return name.rsplit(".", 1)[-1] if name else None


def _unwrap_partial(call: ast.Call) -> Optional[ast.AST]:
    """``functools.partial(f, ...)`` -> the ``f`` node."""
    if last_component(call.func) == "partial" and call.args:
        return call.args[0]
    return None


class ModuleIndex:
    """All the per-module facts the rules need, built in one pass."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.parents: dict = {}
        self.functions: list = []
        # FuncNode -> the transform that traces it DIRECTLY ("vmap",
        # "checkpoint", "Function", ...; nesting is resolved by
        # enclosing_traced / traced_under below)
        self.traced: dict = {}
        # module-level NAME = <int literal> bindings (salt constants)
        self.int_constants: dict = {}
        # local name -> (module-as-written, original name) for from-imports
        self.imports_from: dict = {}
        # local alias -> full dotted module for ``import a.b.c as x``
        self.import_aliases: dict = {}
        # cross-module constant table, attached by lint_paths (None when
        # linting a single source string standalone)
        self.project: Optional["ProjectIndex"] = None
        self._func_defs: dict = {}    # name -> [FuncNode]
        self._build()

    # -- construction -------------------------------------------------

    def _build(self):
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        for stmt in self.tree.body:
            tgts, val = None, None
            if isinstance(stmt, ast.Assign):
                tgts, val = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgts, val = [stmt.target], stmt.value
            if tgts and isinstance(val, ast.Constant) \
                    and isinstance(val.value, int) \
                    and not isinstance(val.value, bool):
                for t in tgts:
                    if isinstance(t, ast.Name):
                        self.int_constants[t.id] = val.value
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                self.functions.append(node)
                if not isinstance(node, ast.Lambda):
                    self._func_defs.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ImportFrom):
                mod = "." * node.level + (node.module or "")
                for a in node.names:
                    self.imports_from[a.asname or a.name] = (mod, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:      # ``import a.b.c as x`` -> x
                        self.import_aliases[a.asname] = a.name
                    elif "." not in a.name:
                        self.import_aliases[a.name] = a.name
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._mark_decorated(node)
            elif isinstance(node, ast.Call):
                self._mark_call(node)
            elif isinstance(node, ast.ClassDef):
                self._mark_function_class(node)

    def _transform(self, node: ast.AST) -> Optional[str]:
        """The transform a callee names (``vmap``), or None when it is no
        torch transform."""
        comp = last_component(node)
        if comp not in _TRACING_CALLS:
            return None
        name = self.qualify(node) or ""
        if not name.startswith("torch.") or ".autograd." in name:
            return None
        return comp

    def _mark_decorated(self, func):
        for dec in func.decorator_list:
            target = dec
            if isinstance(dec, ast.Call):
                inner = _unwrap_partial(dec)
                # @functools.partial(torch.compile, ...) or
                # @torch.compile(mode=...)
                target = inner if inner is not None else dec.func
            comp = self._transform(target)
            if comp is not None:
                self.traced[func] = comp

    def _mark_call(self, call: ast.Call):
        comp = self._transform(call.func)
        if comp is None:
            return
        for pos in _TRACING_CALLS[comp]:
            if pos >= len(call.args):
                continue
            traced_arg = call.args[pos]
            if isinstance(traced_arg, ast.Call):
                # vmap(functools.partial(body, ...))
                traced_arg = _unwrap_partial(traced_arg)
            if isinstance(traced_arg, ast.Lambda):
                self.traced.setdefault(traced_arg, comp)
            elif isinstance(traced_arg, ast.Name):
                for fn in self._func_defs.get(traced_arg.id, []):
                    self.traced.setdefault(fn, comp)

    def _mark_function_class(self, cls: ast.ClassDef):
        """``forward``/``backward``/... of a subclass of
        ``torch.autograd.Function``."""
        if not any((self.qualify(b) or "").endswith("autograd.Function")
                   for b in cls.bases):
            return
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name in _FUNCTION_METHODS:
                self.traced.setdefault(stmt, "Function")

    # -- queries ------------------------------------------------------

    def qualify(self, node: ast.AST) -> Optional[str]:
        """The dotted name of ``node`` with its root resolved through the
        module's imports: ``dist.all_reduce`` -> ``torch.distributed.
        all_reduce``, ``checkpoint`` (from ``torch.utils.checkpoint``) ->
        ``torch.utils.checkpoint.checkpoint``. A root bound by no import
        stays as written (a local name or a builtin)."""
        name = dotted_name(node)
        if name is None:
            return None
        root, _, rest = name.partition(".")
        if root in self.import_aliases:
            full = self.import_aliases[root]
        elif root in self.imports_from:
            mod, orig = self.imports_from[root]
            full = f"{mod}.{orig}" if mod and not mod.endswith(".") \
                else mod + orig
        else:
            full = root
        return f"{full}.{rest}" if rest else full

    def enclosing_function(self, node: ast.AST) -> Optional[FuncNode]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_def(self, node: ast.AST) -> Optional[FuncNode]:
        """The nearest enclosing ``def`` (lambdas are looked through)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_traced(self, node: ast.AST) -> Optional[str]:
        """The transform governing ``node``: that of the nearest enclosing
        function that is directly traced (bodies nested inside a traced
        body are traced too)."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)) and cur in self.traced:
                return self.traced[cur]
            cur = self.parents.get(cur)
        return None

    def in_traced(self, node: ast.AST) -> bool:
        return self.enclosing_traced(node) is not None

    def traced_under(self, node: ast.AST, transform: str
                     ) -> Optional[FuncNode]:
        """The outermost enclosing function that ``transform`` traces
        directly (so a ``grad`` lambda inside a ``vmap`` body is under
        ``vmap`` too), or None."""
        found = None
        cur: Optional[ast.AST] = node
        while cur is not None:
            if self.traced.get(cur) == transform:
                found = cur
            cur = self.parents.get(cur)
        return found

    def resolve_int(self, node: ast.AST) -> Optional[int]:
        """Resolve an expression to a compile-time integer: a literal, a
        module-level constant in this file, or (when a ``ProjectIndex`` is
        attached) a constant imported from another linted module. None for
        anything data-dependent: rules built on this skip, never guess."""
        if isinstance(node, ast.Constant):
            v = node.value
            return v if isinstance(v, int) and not isinstance(v, bool) \
                else None
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            inner = self.resolve_int(node.operand)
            return None if inner is None else -inner
        if isinstance(node, ast.Name):
            if node.id in self.int_constants:
                return self.int_constants[node.id]
            imp = self.imports_from.get(node.id)
            if imp is not None and self.project is not None:
                return self.project.lookup(imp[0], imp[1])
            return None
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name is None or self.project is None:
                return None
            mod, _, attr = name.rpartition(".")
            root = mod.split(".", 1)[0]
            if root in self.import_aliases:
                full = self.import_aliases[root]
                mod = full + mod[len(root):]
            return self.project.lookup(mod, attr)
        return None

    def tainted_params(self, func: FuncNode) -> set:
        """Names that hold batched tensors inside a traced function: its
        own parameters (but ``self``/``cls``/``ctx``) plus one level of
        tuple-unpacking of those parameters (``state, theta = carry``)."""
        args = getattr(func, "args", None)
        if args is None:
            return set()
        names = {a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)}
        if args.vararg:
            names.add(args.vararg.arg)
        names -= _NOT_TENSORS
        body = func.body if isinstance(func.body, list) else []
        for stmt in body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.value, ast.Name)
                    and stmt.value.id in names):
                tgt = stmt.targets[0]
                if isinstance(tgt, (ast.Tuple, ast.List)):
                    for e in tgt.elts:
                        if isinstance(e, ast.Name):
                            names.add(e.id)
        return names


def module_dotted_path(path: str) -> str:
    """``src/repro_torch/faults/spec.py`` -> ``repro_torch.faults.spec``:
    the dotted key a file is registered under in a ``ProjectIndex``. A
    leading ``src/`` component is dropped (the repo's layout);
    ``__init__.py`` maps to its package."""
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [c for c in p.split("/") if c not in ("", ".", "..")]
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ProjectIndex:
    """Module-level integer constants across every file of one lint run.

    Built by ``linter.lint_paths`` as a prepass and attached to each
    ``ModuleIndex`` so ``resolve_int`` can follow a salt constant through
    ``from .spec import _SALT_DROP``: the cross-module half of RPL009.
    Lookup tail-matches the module reference as written at the import site
    (``..faults.spec``, ``spec``) against the registered dotted paths;
    ambiguous or conflicting matches resolve to None (skip, never
    guess)."""

    def __init__(self):
        self._consts: dict = {}   # dotted module path -> {NAME: int}

    def add(self, path: str, index: ModuleIndex):
        self._consts[module_dotted_path(path)] = dict(index.int_constants)

    def lookup(self, module_expr: str, name: str) -> Optional[int]:
        tail = module_expr.lstrip(".")
        if not tail:
            return None
        hits = []
        for mod, consts in self._consts.items():
            if (mod == tail or mod.endswith("." + tail)) and name in consts:
                hits.append(consts[name])
        return hits[0] if len(set(hits)) == 1 else None
