"""Intraprocedural ``torch.Generator`` def-use analysis behind RPL007 (the
counterpart of ``repro/analysis/keyflow.py``, which follows JAX keys).

The port's determinism contract is an explicit-generator discipline:
every draw names its ``torch.Generator`` (``generator=``), and every
stream is opened once. A generator advances as it is drawn from, so
drawing twice from ONE generator is the idiom; what replays a stream is
opening it twice: two generators made from the same seed expression (the
same ``lane_generator(seed, index, salt)``, the same
``torch.Generator().manual_seed(s)``, the same ``set_state(state)``) that
both feed draws, or a generator restored to a state it already drew past.
Their draws are the same numbers, where the MM analysis needs them
independent.

``GeneratorFlow`` walks one module and tracks which names hold which
generator INSTANCE, and which STREAM each instance opened: a stream is
the creator's kind and seed expression together with the version of
every name that expression reads, so a seed whose inputs were rebound
in between (a loop index, a round counter) opens a new stream.

Like everything in ``modindex``, this is a lexical heuristic, not an
abstract interpreter: branches fork the state and re-merge (an arm that
returns/raises drops out of the merge), loop and comprehension bodies
run twice so a stream reopened every iteration from a loop-invariant
seed fires, a seed expression that calls anything but a pure conversion
opens a stream of its own, and only bare names are tracked. Passing a
generator to a function does not draw from it (the reference's keys
likewise).
"""
from __future__ import annotations

import ast
import itertools
from typing import Optional

from .modindex import ModuleIndex, dotted_name, last_component

# torch functions that draw from ``generator=`` (the global generator
# without it)
SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "bernoulli", "normal",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
# Tensor methods that draw in place from ``generator=``
METHOD_SAMPLERS = frozenset({
    "uniform_", "normal_", "bernoulli_", "exponential_", "random_",
    "geometric_", "cauchy_", "log_normal_",
})
# callables whose result is a fresh generator seeded from their arguments:
# the fault lanes (faults/spec.py) and the seed -> generator helper of
# api/driver.py
SEEDED_CREATORS = frozenset({"lane_generator", "_as_generator"})
# calls a seed expression may make and still name the same value on every
# evaluation
_PURE_CALLS = frozenset({"int", "float", "abs", "len", "str", "hash", "min",
                         "max", "item", "initial_seed", "tolist", "tuple"})


class TorchNamespace:
    """Which calls of a module are torch samplers and generator makers.
    ``torch.rand`` and its spellings through the module's imports
    (``from torch import rand``); ``np.random.normal`` is no sampler."""

    def __init__(self, index: ModuleIndex):
        self.index = index

    def sampler_of(self, call: ast.Call) -> Optional[str]:
        """The sampler a call resolves to (``rand``, ``uniform_``), else
        None."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in METHOD_SAMPLERS:
            return func.attr
        name = self.index.qualify(func) or ""
        parts = name.split(".")
        if parts[-1] in SAMPLERS and parts[0] == "torch" and len(parts) == 2:
            return parts[-1]
        return None

    def creator_of(self, value) -> Optional[str]:
        """How an expression makes a new generator, else None: ``"default"``
        (``torch.Generator(...)``), ``"seed"`` (its ``.manual_seed(e)``),
        ``"lane_generator"`` or ``"_as_generator"``."""
        if not isinstance(value, ast.Call):
            return None
        if self.is_generator_ctor(value):
            return "default"
        func = value.func
        if isinstance(func, ast.Attribute) and func.attr == "manual_seed" \
                and self.is_generator_ctor(func.value) and value.args:
            return "seed"
        comp = last_component(func)
        return comp if comp in SEEDED_CREATORS else None

    def is_generator_ctor(self, node: ast.AST) -> bool:
        """``torch.Generator(...)``."""
        return (isinstance(node, ast.Call)
                and (self.index.qualify(node.func) or "")
                == "torch.Generator")


def generator_arg(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "generator":
            return kw.value
    return None


class Replay:
    """One replay site: ``node`` draws from a stream that ``first_node``
    already drew from through another generator."""

    __slots__ = ("node", "name", "fn", "first_node", "first_fn",
                 "first_name")

    def __init__(self, node, name, fn, first_node, first_fn, first_name):
        self.node = node
        self.name = name
        self.fn = fn
        self.first_node = first_node
        self.first_fn = first_fn
        self.first_name = first_name


class _State:
    """Per-path dataflow state: which generator instance each name holds,
    the version of every rebound name, the snapshot stream a name holds
    (``s = g.get_state()``), and which instance first drew from each
    stream (with its call, for the message)."""

    __slots__ = ("gen", "ver", "snap", "drawn")

    def __init__(self, gen=None, ver=None, snap=None, drawn=None):
        self.gen = dict(gen or {})        # name -> instance id
        self.ver = dict(ver or {})        # name -> version
        self.snap = dict(snap or {})      # name -> stream
        self.drawn = dict(drawn or {})    # stream -> (inst, node, fn, name)

    def copy(self) -> "_State":
        return _State(self.gen, self.ver, self.snap, self.drawn)


class GeneratorFlow:
    """Run the def-use pass over every scope of a module; collect
    ``Replay`` records in ``self.replays``."""

    def __init__(self, index: ModuleIndex):
        self.index = index
        self.ns = TorchNamespace(index)
        self.replays: list = []
        self._ids = itertools.count(1)
        self._stream: dict = {}            # instance id -> stream
        self._reported: set = set()

    def run(self) -> "GeneratorFlow":
        self._walk_stmts(self.index.tree.body, _State())
        for fn in self.index.functions:
            st = _State()
            if isinstance(fn.body, list):
                self._walk_stmts(fn.body, st)
            else:                          # Lambda
                self._expr(fn.body, st)
        return self

    # -- instances and streams -----------------------------------------

    def _instance(self, stream) -> int:
        inst = next(self._ids)
        self._stream[inst] = stream
        return inst

    def _unique(self) -> tuple:
        return ("unique", next(self._ids))

    def _seed_stream(self, kind: str, exprs, st) -> tuple:
        """The stream a creator opens from ``exprs``: their text and the
        version of every name they read, or a stream of its own when they
        call anything impure."""
        names = set()
        for e in exprs:
            for n in ast.walk(e):
                if isinstance(n, ast.Call) \
                        and last_component(n.func) not in _PURE_CALLS:
                    return self._unique()
                if isinstance(n, ast.Name):
                    names.add(n.id)
        return (kind, tuple(ast.dump(e) for e in exprs),
                tuple(sorted((n, st.ver.get(n, 0)) for n in names)))

    def _created_stream(self, value, st) -> Optional[tuple]:
        """The stream an expression that makes a new generator opens, else
        None."""
        kind = self.ns.creator_of(value)
        if kind is None:
            return None
        if kind == "seed":
            ctor = value.func.value
            return self._seed_stream(
                kind, ctor.args + ctor.keywords + value.args[:1], st)
        # an unseeded generator starts from torch's one default seed
        return self._seed_stream(kind, value.args + value.keywords, st)

    # -- statements ----------------------------------------------------

    def _walk_stmts(self, stmts, st) -> bool:
        """True when control definitely leaves (return/raise/break)."""
        for s in stmts:
            if self._stmt(s, st):
                return True
        return False

    def _stmt(self, s, st) -> bool:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return False          # separate scopes, analysed on their own
        if isinstance(s, ast.Return):
            self._expr(s.value, st)
            return True
        if isinstance(s, ast.Raise):
            self._expr(s.exc, st)
            self._expr(s.cause, st)
            return True
        if isinstance(s, (ast.Break, ast.Continue)):
            return True
        if isinstance(s, ast.Assign):
            self._expr(s.value, st)
            for t in s.targets:
                self._bind(t, s.value, st)
            return False
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value, st)
                self._bind(s.target, s.value, st)
            return False
        if isinstance(s, ast.AugAssign):
            self._expr(s.value, st)
            self._bind(s.target, None, st)
            return False
        if isinstance(s, ast.If):
            self._expr(s.test, st)
            st_t, st_f = st.copy(), st.copy()
            t_term = self._walk_stmts(s.body, st_t)
            f_term = self._walk_stmts(s.orelse, st_f)
            if t_term and f_term:
                return True
            if t_term:
                self._adopt(st, st_f)
            elif f_term:
                self._adopt(st, st_t)
            else:
                self._merge(st, st_t, st_f)
            return False
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, st)
            for _ in range(2):
                self._bind(s.target, None, st)
                self._walk_stmts(s.body, st)
            self._walk_stmts(s.orelse, st)
            return False
        if isinstance(s, ast.While):
            for _ in range(2):
                self._expr(s.test, st)
                self._walk_stmts(s.body, st)
            self._walk_stmts(s.orelse, st)
            return False
        if isinstance(s, ast.Try) or (hasattr(ast, "TryStar")
                                      and isinstance(s, ast.TryStar)):
            self._walk_stmts(s.body, st)
            for h in s.handlers:
                hs = st.copy()
                self._walk_stmts(h.body, hs)
                for k, v in hs.drawn.items():
                    st.drawn.setdefault(k, v)
            self._walk_stmts(s.orelse, st)
            self._walk_stmts(s.finalbody, st)
            return False
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr(item.context_expr, st)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, None, st)
            return self._walk_stmts(s.body, st)
        if isinstance(s, ast.Expr):
            self._expr(s.value, st)
            return False
        if isinstance(s, ast.Delete):
            for t in s.targets:
                self._bind(t, None, st)
            return False
        if isinstance(s, ast.Assert):
            self._expr(s.test, st)
            self._expr(s.msg, st)
            return False
        if isinstance(s, (ast.Global, ast.Nonlocal, ast.Pass, ast.Import,
                          ast.ImportFrom)):
            return False
        for child in ast.iter_child_nodes(s):   # Match etc.: best effort
            if isinstance(child, ast.expr):
                self._expr(child, st)
            elif isinstance(child, ast.stmt):
                self._stmt(child, st)
        return False

    @staticmethod
    def _adopt(st, other):
        st.gen, st.ver, st.snap, st.drawn = (other.gen, other.ver,
                                             other.snap, other.drawn)

    def _merge(self, st, a, b):
        # drawn on either arm counts as drawn after the join
        st.drawn = dict(a.drawn)
        for k, v in b.drawn.items():
            st.drawn.setdefault(k, v)
        gen, ver, snap = {}, {}, {}
        for name in set(a.gen) | set(b.gen):
            ga, gb = a.gen.get(name), b.gen.get(name)
            # diverged rebinds: an instance of a stream of its own
            gen[name] = ga if ga == gb else self._instance(self._unique())
        for name in set(a.ver) | set(b.ver):
            va, vb = a.ver.get(name, 0), b.ver.get(name, 0)
            ver[name] = va if va == vb else max(va, vb) + 1
        for name in set(a.snap) & set(b.snap):
            if a.snap[name] == b.snap[name]:
                snap[name] = a.snap[name]
        st.gen, st.ver, st.snap = gen, ver, snap

    # -- bindings ------------------------------------------------------

    def _bind(self, target, value, st):
        if isinstance(target, ast.Name):
            name = target.id
            st.ver[name] = st.ver.get(name, 0) + 1
            st.gen.pop(name, None)
            st.snap.pop(name, None)
            if value is None:
                return
            if isinstance(value, ast.Name) and value.id in st.gen:
                st.gen[name] = st.gen[value.id]    # alias: same generator
                return
            if isinstance(value, ast.Name) and value.id in st.snap:
                st.snap[name] = st.snap[value.id]
                return
            stream = self._created_stream(value, st)
            if stream is not None:
                st.gen[name] = self._instance(stream)
                return
            snapped = self._snapshot(value, st)
            if snapped is not None:
                st.snap[name] = snapped
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = None
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                vals = value.elts
            for i, elt in enumerate(target.elts):
                if isinstance(elt, ast.Starred):
                    elt = elt.value
                self._bind(elt, vals[i] if vals is not None else None, st)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, None, st)
        # attribute / subscript targets: not tracked

    def _snapshot(self, value, st) -> Optional[tuple]:
        """``g.get_state()``: from here on ``g`` (a generator made here or
        handed in) draws a new stream, which the snapshot restores."""
        if not (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "get_state"
                and isinstance(value.func.value, ast.Name)):
            return None
        stream = self._unique()
        st.gen[value.func.value.id] = self._instance(stream)
        return stream

    # -- expressions ---------------------------------------------------

    def _expr(self, e, st):
        if e is None or isinstance(e, ast.Lambda):
            return                       # lambdas are separate scopes
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            self._comprehension(e, st)
            return
        if isinstance(e, ast.Call):
            for a in e.args:
                self._expr(a.value if isinstance(a, ast.Starred) else a, st)
            for kw in e.keywords:
                self._expr(kw.value, st)
            self._expr(e.func, st)
            self._reseed(e, st)
            self._draw(e, st)
            return
        if isinstance(e, ast.IfExp):
            self._expr(e.test, st)
            a, b = st.copy(), st.copy()
            self._expr(e.body, a)
            self._expr(e.orelse, b)
            self._merge(st, a, b)
            return
        if isinstance(e, ast.BoolOp):
            self._expr(e.values[0], st)
            for v in e.values[1:]:       # short-circuit arms may not run
                arm = st.copy()
                self._expr(v, arm)
                self._merge(st, st.copy(), arm)
            return
        if isinstance(e, ast.NamedExpr):
            self._expr(e.value, st)
            self._bind(e.target, e.value, st)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, st)

    def _comprehension(self, e, st):
        local = st.copy()
        for gen in e.generators:
            self._expr(gen.iter, local)
        bodies = [e.key, e.value] if isinstance(e, ast.DictComp) else [e.elt]
        for _ in range(2):   # the element expression runs once PER item
            for gen in e.generators:
                self._bind(gen.target, None, local)
                for cond in gen.ifs:
                    self._expr(cond, local)
            for b in bodies:
                self._expr(b, local)
        # draws from enclosing-scope streams escape the comprehension
        for k, v in local.drawn.items():
            st.drawn.setdefault(k, v)

    def _reseed(self, call, st):
        """``g.manual_seed(e)`` / ``g.set_state(s)`` on a name: ``g`` opens
        the stream of ``e`` or of ``s``."""
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in ("manual_seed", "set_state")
                and isinstance(func.value, ast.Name) and call.args):
            return
        arg = call.args[0]
        if func.attr == "set_state" and isinstance(arg, ast.Name) \
                and arg.id in st.snap:
            stream = st.snap[arg.id]
        else:
            kind = "seed" if func.attr == "manual_seed" else "state"
            stream = self._seed_stream(kind, [arg], st)
        st.gen[func.value.id] = self._instance(stream)

    def _draw(self, call, st):
        fn = self.ns.sampler_of(call)
        if fn is None:
            return
        arg = generator_arg(call)
        if isinstance(arg, ast.Name) and arg.id in st.gen:
            inst, name = st.gen[arg.id], arg.id
        else:
            stream = self._created_stream(arg, st)
            if stream is None:
                return                   # a generator we did not see made
            inst, name = self._instance(stream), dotted_name(
                arg.func) or "<generator>"
        stream = self._stream[inst]
        prev = st.drawn.get(stream)
        if prev is None:
            st.drawn[stream] = (inst, call, fn, name)
            return
        if prev[0] == inst:
            return                       # one generator advancing: the idiom
        site = (call.lineno, call.col_offset)
        if site in self._reported:
            return
        self._reported.add(site)
        self.replays.append(Replay(call, name, fn, prev[1], prev[2],
                                   prev[3]))
