"""Rematerialisation: a call whose saved tensors are recomputed in the
backward rather than kept from the forward.

`remat_call` does what ``torch.utils.checkpoint`` (non-reentrant) does, with
saved-tensor hooks alone: the forward keeps a count for each tensor it
would save, and the first unpack reruns the call on its inputs' values.  It
replaces ``torch.utils.checkpoint`` in this package for two reasons: on a
mesh of several cards two threads of the autograd engine may reach one
call's saved tensors at once, and the first ``torch.utils.checkpoint``
call of a process imports ``torch._dynamo``, seconds of import for nothing
that runs here.
"""
from __future__ import annotations

import contextlib
import threading

import torch


# the hooks of the remats whose forward or rerun this thread is inside
_LOCAL = threading.local()


def _enclosing() -> list:
    if not hasattr(_LOCAL, "hooks"):
        _LOCAL.hooks = []
    return _LOCAL.hooks


class Remat:
    """One call of ``fn(*args)`` rematerialised in the backward, as
    ``torch.utils.checkpoint`` (non-reentrant) does it: the forward keeps
    no saved tensor but a count; the first unpack reruns ``fn`` on the
    inputs' values with grad on and hands every later unpack its tensor.
    The rerun is guarded by a lock: on a mesh of several cards the
    autograd engine runs each card's backward on a thread of its own, and
    two of them may reach the same layer's saved tensors at once (torch's
    checkpoint then reruns it twice over one frame and fails)."""

    def __init__(self, fn, args):
        self.fn, self.inputs = fn, args
        self.grads = [a.requires_grad for a in args]
        hooks = _enclosing()
        if hooks:
            # inside an enclosing remat, its hooks keep the inputs: a count
            # in its forward, the tensors in its rerun (as
            # torch.utils.checkpoint saves its inputs), so they are not
            # held from the forward to the backward
            pack, self.unpack_arg = hooks[-1]
            self.args = [pack(a) for a in args]
        else:
            self.unpack_arg = None
            self.args = [a.detach() for a in args]
        self.n = 0
        self.saved = None
        self.lock = threading.Lock()

    def pack(self, x):
        self.n += 1
        return self.n - 1

    def unpack(self, i):
        with self.lock:
            if self.saved is None:
                store = []

                def keep(x):
                    store.append(x.detach() if x.requires_grad else x)
                    return len(store) - 1

                args = self.args if self.unpack_arg is None else \
                    [self.unpack_arg(j) for j in self.args]
                args = [a.detach().requires_grad_(g)
                        for a, g in zip(args, self.grads)]
                with torch.enable_grad(), _hooks(keep, store.__getitem__):
                    self.fn(*args)
                self.saved = store
        return self.saved[i]

    def __call__(self):
        inputs, self.inputs = self.inputs, None
        with _hooks(self.pack, self.unpack):
            return self.fn(*inputs)


@contextlib.contextmanager
def _hooks(pack, unpack):
    """``saved_tensors_hooks(pack, unpack)``, on this thread's stack of
    enclosing remats' hooks for as long."""
    stack = _enclosing()
    stack.append((pack, unpack))
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        stack.pop()


def remat_call(fn, *args):
    """``fn(*args)`` (tensor arguments, any output, gradients on), its
    saved tensors recomputed in the backward (`Remat`)."""
    return Remat(fn, args)()
