"""A capture-safety guard for the tests of the captured graphs (the
prefills and the training steps): inside ``no_host_reads()`` a read of a
tensor on the host (``Tensor.item``, ``.cpu``, ``.tolist``, ``.numpy``,
``__bool__``, ``__int__``, ``__float__``, ``__index__``,
``torch.nonzero``) and host data sent to a device (``torch.tensor`` /
``as_tensor`` with a device, a Python number written with
``__setitem__``) raise, as they would stall, or break, a CUDA graph's
capture."""

import contextlib

import torch

READS = ('item', 'cpu', 'tolist', 'numpy', '__bool__', '__int__',
         '__float__', '__index__')


@contextlib.contextmanager
def no_host_reads():
    saved = {n: getattr(torch.Tensor, n) for n in READS + ('__setitem__',)}
    factories = {'tensor': torch.tensor, 'as_tensor': torch.as_tensor,
                 'nonzero': torch.nonzero}
    setitem = torch.Tensor.__setitem__

    def checked_setitem(t, index, value):
        # a Python number written into a device tensor is a host copy
        if not torch.is_tensor(value):
            raise AssertionError('a captured part wrote a host value into '
                                 'a tensor (Tensor.__setitem__)')
        return setitem(t, index, value)

    def read(name):
        def refuse(*a, **kw):
            raise AssertionError(f'a captured part read a tensor on the '
                                 f'host (Tensor.{name})')
        return refuse

    def upload(name, fn):
        def checked(data, *a, **kw):
            if name == 'nonzero':
                raise AssertionError('a captured part called torch.nonzero')
            if not torch.is_tensor(data) and kw.get('device') is not None:
                raise AssertionError(f'a captured part sent host data to a '
                                     f'device (torch.{name})')
            return fn(data, *a, **kw)
        return checked
    try:
        for n in READS:
            setattr(torch.Tensor, n, read(n))
        for n, fn in factories.items():
            setattr(torch, n, upload(n, fn))
        torch.Tensor.__setitem__ = checked_setitem
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        for n, fn in factories.items():
            setattr(torch, n, fn)


def guard_parts(monkeypatch) -> list:
    """Run every part of every ``TrainGraph`` step, and every
    ``StepGraph`` step (the auction's rounds), under ``no_host_reads``;
    the host step between two parts runs unguarded.  -> the names of the
    parts run, in order."""
    from groma_tpu_torch.utils.graphs import StepGraph, TrainGraph
    ran = []
    run, step_run = TrainGraph.run, StepGraph.run

    def guarded(fn, name):
        def checked(*a):
            with no_host_reads():
                out = fn(*a)
            ran.append(name)
            return out
        return checked

    def guarded_run(self, parts, inputs, **kw):
        return run(self, tuple(guarded(p, f'part {i}')
                               for i, p in enumerate(parts)), inputs, **kw)

    def guarded_step_run(self, n):
        step = self.step
        self.step = guarded(step, 'rounds')
        try:
            return step_run(self, n)
        finally:
            self.step = step
    monkeypatch.setattr(TrainGraph, 'run', guarded_run)
    monkeypatch.setattr(StepGraph, 'run', guarded_step_run)
    return ran
