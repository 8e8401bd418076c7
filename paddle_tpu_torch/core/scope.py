"""Scope: the hierarchical name -> value symbol table of the port (its own
copy of ``paddle_tpu/core/scope.py``; reference:
paddle/fluid/framework/scope.h:48 Scope, variable.h:26 Variable).

Values are torch tensors on the device of the executor that put them there
(``core/executor.py``; ``fluid/io.py`` loads arrays straight onto it). An
executor refuses a scope value that lies on another device, so a scope
filled on the card is not read on the CPU, or the other way round.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._parent = parent
        self._vars: Dict[str, Any] = {}
        self._kids: List["Scope"] = []
        # monotonic mutation counter: every set_var/erase bumps it (the
        # reference's compiled blocks key a resident-state cache on it;
        # the port's runner gathers every run and only exposes it)
        self._mutations = 0

    # reference: scope.h:56 NewScope
    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    # reference: scope.h Var()
    def set_var(self, name: str, value) -> None:
        self._mutations += 1
        self._vars[name] = value

    def version(self) -> int:
        """Mutation clock covering this scope AND its parent chain
        (find_var resolves through parents, so a parent write counts
        for a child too)."""
        v = 0
        s: Optional[Scope] = self
        while s is not None:
            v += s._mutations
            s = s._parent
        return v

    # reference: scope.h FindVar — walks up the parent chain
    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def erase(self, names) -> None:
        self._mutations += 1
        for n in names:
            self._vars.pop(n, None)

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def iter_vars(self):
        """Yield (name, value) for this scope and every descendant (a
        shadowed name yields once per holding scope)."""
        for item in self._vars.items():
            yield item
        for kid in self._kids:
            yield from kid.iter_vars()

    def drop_kids(self) -> None:
        self._kids.clear()


_global_scope = Scope()


def global_scope() -> Scope:
    """reference: pybind.cc exposes the same singleton to executor.py."""
    return _global_scope


def _reset_global_scope_for_tests() -> None:
    global _global_scope
    _global_scope = Scope()


def _switch_scope(scope: Scope) -> Scope:
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old
