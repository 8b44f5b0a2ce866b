"""Pluggable serializer — what crosses the agent→worker process boundary.

RP learned this lesson the hard way (its ``utils/serializer`` grew pickle,
dill and cloudpickle backends): the moment task functions execute in a
different process, *serialization policy* becomes runtime policy.  A plain
``pickle`` refuses closures, lambdas and ``__main__`` functions — i.e.
most task bodies a workflow script actually writes — and silently pins
device arrays.  This module is the single place those rules live, shared
by the process transport (transport.py) for functions, arguments, results,
checkpoint payloads and exceptions.

Design points (each one a failure mode seen in the wild):

* **Callable-by-value fallback.**  ``dumps`` first lets pickle serialize a
  function by reference (importable module-level functions stay cheap and
  version-robust).  Functions pickle-by-ref cannot express — closures,
  lambdas, ``__main__``/unimportable functions — are captured *by value*:
  ``marshal``-ed code object, closure cell contents, defaults, and the
  referenced subset of the function's globals (modules travel as import
  references; unserializable globals are dropped and resolve to the
  child's builtins or a NameError at call time, never a submit failure).

* **Exception round-tripping.**  A task failure in a worker process must
  surface in the parent with its *remote* traceback, not a bare
  ``EOFError``.  ``pack_exception`` carries the formatted remote traceback
  alongside the exception; unpacking re-attaches it as ``__cause__`` (a
  ``RemoteTraceback``) so the user-visible chain reads exactly like
  ``concurrent.futures``' remote errors.  Exceptions that cannot
  round-trip (unpicklable state, constructor signature surprises) degrade
  to a ``RemoteError`` carrier with the original repr + traceback.

* **Tensors are host-transferred before crossing.**  A ``torch.Tensor``
  anywhere in args/results/checkpoint state crosses as
  ``t.detach().cpu()``, so the receiving process never needs a CUDA
  context just to look at a value, and a forked worker never touches the
  parent's CUDA runtime (a forked child cannot use it).  A CPU tensor
  without autograd history pickles as it is.  The hook only engages when
  torch is already imported in the sending process.

* **Graceful unserializable-result degradation.**  ``pack_result`` never
  raises: a result that cannot cross the boundary completes the task with
  an ``UnserializableResult`` placeholder (repr preserved) instead of
  failing it — the same contract the journal already applies to
  non-JSON-serializable results (docs/performance.md: the line is
  slimmed, the value is unpinned, a restart re-executes).
"""
from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import traceback
import types
from typing import Any, Optional, Tuple


class SerializationError(Exception):
    """The object cannot cross the process boundary."""


class RemoteTraceback(Exception):
    """Formatted traceback of an exception raised in a worker process,
    attached as ``__cause__`` of the re-raised exception (the
    ``concurrent.futures`` convention, so tracebacks render as
    'The above exception was the direct cause of ...')."""

    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self):
        return "\n" + self.tb


class RemoteError(RuntimeError):
    """Carrier for a remote exception that could not itself round-trip
    (unpicklable state or constructor); the message preserves the
    original type and repr, the attached RemoteTraceback the stack."""


class UnserializableResult:
    """Placeholder completing a proc-mode task whose result could not
    cross the boundary: the task is DONE, the repr is kept for
    observability, and — exactly like the journal's slimmed line — any
    consumer that needs the real value must recompute it."""

    def __init__(self, type_name: str, repr_str: str):
        self.type_name = type_name
        self.repr = repr_str

    def __repr__(self):
        return (f"<UnserializableResult {self.type_name}: "
                f"{self.repr[:120]}>")


_EMPTY_CELL = ("__repro_empty_cell__",)


def _load_module(name: str):
    try:
        return importlib.import_module(name)
    except Exception:  # noqa: BLE001 — a missing module in the receiver
        return None    # resolves to None; call-time NameError, not a crash


class _ModuleRef:
    """Modules travel as import-by-name references."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def _code_names(code) -> set:
    """Global names a code object (and its nested code objects) may read."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


def _make_function(code_bytes: bytes, name: str, qualname: str,
                   defaults, kwdefaults, closure_vals: tuple,
                   globals_items: tuple, module: str):
    """Receiver-side reconstruction of a by-value function."""
    code = marshal.loads(code_bytes)
    g = {"__builtins__": builtins, "__name__": module or "__remote__"}
    for k, v in globals_items:
        g[k] = _load_module(v.name) if isinstance(v, _ModuleRef) else v
    cells = tuple(
        types.CellType() if v == _EMPTY_CELL else types.CellType(v)
        for v in closure_vals)
    fn = types.FunctionType(code, g, name, defaults, cells or None)
    fn.__kwdefaults__ = kwdefaults
    fn.__qualname__ = qualname
    # a recursive by-value function calls itself through its globals
    if name not in g:
        g[name] = fn
    return fn


def _pickles_by_ref(fn: types.FunctionType) -> bool:
    """True when standard pickle-by-reference will work on both sides:
    a module-level function of an importable, non-__main__ module."""
    if "<locals>" in getattr(fn, "__qualname__", ""):
        return False
    if fn.__module__ in (None, "__main__", "__mp_main__"):
        return False
    mod = sys.modules.get(fn.__module__)
    return mod is not None and getattr(mod, fn.__name__, None) is fn


_BASIC = (type(None), bool, int, float, complex, str, bytes)


class _Pickler(pickle.Pickler):
    """pickle + (tensor→host, module-by-name, function-by-value)
    overrides."""

    def reducer_override(self, obj):
        th = sys.modules.get("torch")
        if (th is not None and isinstance(obj, th.Tensor)
                and (obj.device.type != "cpu" or obj.requires_grad)):
            # host transfer before crossing: the receiver gets a CPU tensor
            # and never needs (or touches) a CUDA context
            return (_identity, (obj.detach().cpu(),))
        if isinstance(obj, types.ModuleType):
            return (_load_module, (obj.__name__,))
        if isinstance(obj, types.FunctionType) and not _pickles_by_ref(obj):
            return _reduce_function(obj)
        return NotImplemented


def _identity(x):
    return x


def _reduce_function(fn: types.FunctionType):
    closure = []
    for cell in (fn.__closure__ or ()):
        try:
            closure.append(cell.cell_contents)
        except ValueError:          # an empty (not yet bound) cell
            closure.append(_EMPTY_CELL)
    gl = []
    for name in sorted(_code_names(fn.__code__)):
        if name not in fn.__globals__:
            continue                # builtin / local — resolves receiver-side
        v = fn.__globals__[name]
        if isinstance(v, types.ModuleType):
            gl.append((name, _ModuleRef(v.__name__)))
        elif isinstance(v, (types.FunctionType, type)) or isinstance(v, _BASIC):
            gl.append((name, v))    # recursive reducer / by-ref handles these
        else:
            try:                    # arbitrary global state: probe, drop
                dumps(v)            # what cannot travel (call-time
                gl.append((name, v))    # NameError beats submit failure)
            except Exception:  # noqa: BLE001
                continue
    return (_make_function,
            (marshal.dumps(fn.__code__), fn.__name__, fn.__qualname__,
             fn.__defaults__, fn.__kwdefaults__, tuple(closure), tuple(gl),
             fn.__module__))


# --------------------------------- api ---------------------------------- #
def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    try:
        _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    except SerializationError:
        raise
    except Exception as e:  # noqa: BLE001 — normalize every pickle failure
        raise SerializationError(
            f"cannot serialize {type(obj).__name__}: {e!r}") from e
    return buf.getvalue()


def loads(blob: bytes) -> Any:
    return pickle.loads(blob)


def pack_task(fn, args: tuple, kwargs: dict) -> bytes:
    """One blob for the worker's run request; raises SerializationError
    (the transport then falls back to in-process execution)."""
    return dumps((fn, args, kwargs))


def pack_result(obj: Any) -> Tuple[Optional[bytes],
                                   Optional[Tuple[str, str]]]:
    """(blob, None) normally; (None, (type_name, repr)) when the result
    cannot cross — the graceful-degradation path, never an exception."""
    try:
        return dumps(obj), None
    except (SerializationError, RecursionError):
        try:
            r = repr(obj)
        except Exception:  # noqa: BLE001
            r = "<repr failed>"
        return None, (type(obj).__name__, r[:500])


def pack_exception(exc: BaseException) -> bytes:
    """Always succeeds: the exception itself when it round-trips, a
    RemoteError carrier (type + repr preserved) when it cannot."""
    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    try:
        blob = dumps((exc, tb))
        loads(blob)                 # verify the round trip *now*: a
        return blob                 # constructor surprise must not
    except Exception:  # noqa: BLE001 — surface as a parent-side crash
        carrier = RemoteError(f"{type(exc).__name__}: {exc}")
        return dumps((carrier, tb))


def unpack_exception(blob: bytes) -> BaseException:
    exc, tb = loads(blob)
    exc.__cause__ = RemoteTraceback(tb)
    exc.remote_traceback = tb
    return exc
