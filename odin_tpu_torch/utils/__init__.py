"""Generic host utilities of the port: a copy of the JAX package's
``odin_tpu/utils/__init__.py`` (which imports no JAX), with its
submodules beside it (``cli``, ``crypto``, ``decorators``, ``mpi``,
``np_utils``, ``ordered_flag``, ``pdf_utils``, ``progbar``,
``python_utils``).  The managed directories lie under ``$ODIN_TPU_HOME``
(``~/.odin_tpu`` without it), the same ones the JAX package uses.
``save_wav`` writes through the port's ``preprocessing.speech.save_wave``;
psutil, IPython, ``cryptography`` and the PDF readers are imported where a
function needs them, as in JAX.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "as_tuple",
    "save_wav",
    "minibatch",
    "md5_checksum",
    "UnitTimer",
    "get_cache_path",
    "get_data_path",
    "get_exp_path",
    "get_datasetpath",
    "get_exppath",
    "one_hot",
    "cache_disk",
    "cache_memory",
    "get_system_status",
    "get_process_status",
    "Progbar",
    "ArgController",
    "stdio",
]


def as_tuple(x: Any, N: Optional[int] = None, t: Optional[type] = None) -> tuple:
  """Coerce `x` into a tuple, optionally repeated to length `N` and cast to `t`.

  Mirrors the semantics of the reference's `as_tuple`
  (``odin/utils/__init__.py``): scalars are repeated; sequences of length 1
  are broadcast to N; length mismatches raise.
  """
  if isinstance(x, (list, tuple, np.ndarray)) and not isinstance(x, str):
    x = tuple(x)
  else:
    x = (x,)
  if N is not None:
    if len(x) == 1:
      x = x * int(N)
    elif len(x) != N:
      raise ValueError(f"expected {N} values but got {len(x)}: {x}")
  if t is not None:
    x = tuple(t(i) for i in x)
  return x


def minibatch(batch_size: int,
              n: Optional[int] = None,
              *arrays,
              seed: Optional[int] = None,
              shuffle: bool = False) -> Iterator:
  """Yield (start, end) index pairs — or array slices — of size `batch_size`.

  Reference: ``odin/utils/__init__.py:191`` (`minibatch`).
  """
  if len(arrays) > 0 and n is None:
    n = len(arrays[0])
  assert n is not None, "either n or arrays must be given"
  indices = None
  if shuffle:
    rng = np.random.RandomState(seed)
    indices = rng.permutation(n)
  for start in range(0, n, batch_size):
    end = min(start + batch_size, n)
    if len(arrays) == 0:
      if indices is None:
        yield start, end
      else:
        yield indices[start:end]
    else:
      if indices is None:
        yield tuple(a[start:end] for a in arrays) if len(arrays) > 1 else arrays[0][start:end]
      else:
        idx = indices[start:end]
        yield tuple(a[idx] for a in arrays) if len(arrays) > 1 else arrays[0][idx]


def md5_checksum(obj: Any) -> str:
  """md5 of a file path, bytes, ndarray, or arbitrary picklable object.

  Reference: ``odin/utils/crypto.py:117``.
  """
  md5 = hashlib.md5()
  if isinstance(obj, str) and os.path.isfile(obj):
    with open(obj, "rb") as f:
      for chunk in iter(lambda: f.read(1 << 20), b""):
        md5.update(chunk)
  elif isinstance(obj, bytes):
    md5.update(obj)
  elif isinstance(obj, np.ndarray):
    md5.update(np.ascontiguousarray(obj).tobytes())
  else:
    md5.update(pickle.dumps(obj))
  return md5.hexdigest()


class UnitTimer:
  """Context-manager timer (reference: ``odin/utils/__init__.py:127``)."""

  def __init__(self, name: str = "", verbose: bool = True):
    self.name = name
    self.verbose = verbose
    self.duration = 0.0

  def __enter__(self):
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.duration = time.perf_counter() - self._start
    if self.verbose:
      print(f"[timer]{' ' + self.name if self.name else ''}: {self.duration:.4f}s")
    return False


def _managed_path(kind: str) -> str:
  base = os.environ.get("ODIN_TPU_HOME", os.path.join(os.path.expanduser("~"), ".odin_tpu"))
  path = os.path.join(base, kind)
  os.makedirs(path, exist_ok=True)
  return path


def get_cache_path() -> str:
  """Managed cache dir (reference: ``odin/utils/__init__.py:1170-1276``)."""
  return _managed_path("cache")


def get_data_path() -> str:
  return _managed_path("datasets")


def get_exp_path() -> str:
  return _managed_path("experiments")


def one_hot(y: np.ndarray, num_classes: Optional[int] = None, dtype="float32") -> np.ndarray:
  """Dense one-hot encoding (reference: ``odin/preprocessing/signal.py:1140``)."""
  y = np.asarray(y, dtype="int64").ravel()
  if num_classes is None:
    num_classes = int(y.max()) + 1
  out = np.zeros((len(y), num_classes), dtype=dtype)
  out[np.arange(len(y)), y] = 1.0
  return out


# reference-name aliases (``odin/utils/__init__.py:1170-1276``)
def get_datasetpath(*a, **kw) -> str:
  return get_data_path()


def get_exppath(*a, **kw) -> str:
  return get_exp_path()


def cache_memory(fn: Callable) -> Callable:
  """In-process memoization keyed by the md5 of the arguments
  (reference ``odin/utils/cache_utils.py:66``)."""
  import functools
  _store = {}

  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    key = md5_checksum((args, tuple(sorted(kwargs.items()))))
    if key not in _store:
      _store[key] = fn(*args, **kwargs)
    return _store[key]

  wrapped.cache_clear = _store.clear
  return wrapped


def get_system_status(scale_factor: float = 1.0) -> dict:
  """Host memory/CPU snapshot (reference ``odin/utils/__init__.py:1433``);
  psutil-gated with an os-level fallback."""
  try:
    import psutil
    vm = psutil.virtual_memory()
    return {"cpu_count": psutil.cpu_count(),
            "cpu_percent": psutil.cpu_percent(),
            "memory_total": vm.total * scale_factor,
            "memory_available": vm.available * scale_factor,
            "memory_percent": vm.percent}
  except ImportError:
    return {"cpu_count": os.cpu_count(), "cpu_percent": None,
            "memory_total": None, "memory_available": None,
            "memory_percent": None}


def get_process_status(pid: Optional[int] = None) -> dict:
  """Per-process rss/cpu snapshot (reference ``utils/__init__.py:1456``)."""
  try:
    import psutil
    p = psutil.Process(pid)
    return {"pid": p.pid, "rss": p.memory_info().rss,
            "cpu_percent": p.cpu_percent(), "threads": p.num_threads()}
  except ImportError:
    return {"pid": pid or os.getpid(), "rss": None, "cpu_percent": None,
            "threads": None}


def cache_disk(fn: Callable) -> Callable:
  """Disk-memoize `fn` keyed by the md5 of its arguments.

  Reference: ``odin/utils/cache_utils.py:124`` (`cache_disk`).
  """
  import functools

  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    key = md5_checksum((fn.__module__, fn.__qualname__, args, tuple(sorted(kwargs.items()))))
    path = os.path.join(get_cache_path(), f"{fn.__name__}_{key}.pkl")
    if os.path.exists(path):
      with open(path, "rb") as f:
        return pickle.load(f)
    out = fn(*args, **kwargs)
    with open(path, "wb") as f:
      pickle.dump(out, f)
    return out

  return wrapped


# re-exports of the reference's headline utilities living in submodules
from odin_tpu_torch.utils.progbar import Progbar  # noqa: E402
from odin_tpu_torch.utils.cli import ArgController, stdio  # noqa: E402
from odin_tpu_torch.utils.mpi import MPI, SharedCounter, async_process, async_thread  # noqa: E402


def flatten_list(seq, level=None):
  """Flatten nested lists/tuples (reference ``utils`` `flatten_list`);
  `level` bounds the recursion depth (None = fully flat)."""
  out = []
  for item in seq:
    if isinstance(item, (list, tuple)) and (level is None or level > 0):
      out.extend(flatten_list(
          item, None if level is None else level - 1))
    else:
      out.append(item)
  return out


_ANSI = {"red": "\033[91m", "green": "\033[92m", "yellow": "\033[93m",
         "blue": "\033[94m", "magenta": "\033[95m", "cyan": "\033[96m",
         "lightred": "\033[91m", "lightgreen": "\033[92m"}


def ctext(text, color: str = "red") -> str:
  """ANSI-colored text (reference ``utils`` `ctext`); plain when the
  stream is not a tty."""
  import sys as _sys
  code = _ANSI.get(str(color).lower())
  if code is None or not getattr(_sys.stdout, "isatty", lambda: False)():
    return str(text)
  return f"{code}{text}\033[0m"


def eprint(*args, **kwargs):
  """print to stderr (reference ``utils`` `eprint`)."""
  import sys as _sys
  kwargs.setdefault("file", _sys.stderr)
  print(*args, **kwargs)


class MD5object:
  """Mixin: md5 of the object's picklable state
  (reference ``utils/crypto.py` `MD5object`)."""

  @property
  def md5_checksum(self) -> str:
    return md5_checksum(self.__dict__)


__all__ += ["MPI", "SharedCounter", "async_process", "async_thread",
            "flatten_list", "ctext", "eprint", "MD5object"]
from odin_tpu_torch.utils.np_utils import (  # noqa: E402
    array2bytes,
    bytes2array,
    label_splitter,
    one_hot,
    unique_labels,
)
from odin_tpu_torch.utils.ordered_flag import OrderedFlag  # noqa: E402
from odin_tpu_torch.utils.decorators import (  # noqa: E402
    abstractstatic,
    autoattr,
    functionable,
    schedule,
    singleton,
    typecheck,
)
from odin_tpu_torch.utils.pdf_utils import (  # noqa: E402
    get_pdf_text,
    get_pdf_titles,
    rename_pdf,
    sanitize_title,
)
from odin_tpu_torch.utils.python_utils import (  # noqa: E402
    IndexedList,
    bidict,
    defaultdictkey,
    fifodict,
    get_formatted_datetime,
    get_function_arguments,
    is_bool,
    is_lambda,
    is_number,
    is_path,
    is_pickleable,
    is_primitive,
    is_string,
    multikeysdict,
    partialclass,
    struct,
)


def save_wav(path, s, fs):
  """Reference ``utils/__init__.py:1379``; delegates to the stdlib-based
  PCM16 writer in `preprocessing.speech.save_wave`."""
  from odin_tpu_torch.preprocessing.speech import save_wave
  return save_wave(path, s, fs)


# ---------------------------------------------------------------------------
# Long-tail helpers (reference odin/utils — file:line in each docstring)
# ---------------------------------------------------------------------------
def uuid(length: int = 8) -> str:
  """Random alphanumeric id (reference ``utils/__init__.py:399``)."""
  import random
  import string
  chars = string.ascii_letters + string.digits
  return "".join(random.choice(chars) for _ in range(int(length)))


def read_lines(file_path):
  """Strip-read all non-empty lines (reference :237)."""
  with open(file_path, "r") as f:
    return [line.strip() for line in f if line.strip()]


def iter_chunk(it, n: int):
  """Chunk any iterable into lists of size n (reference :179)."""
  from itertools import islice
  it = iter(it)
  obj = list(islice(it, int(n)))
  while obj:
    yield obj
    obj = list(islice(it, int(n)))


def dict_union(*dicts, **kwargs):
  """Union of DISJOINT dicts; duplicate keys raise (reference :1084)."""
  out = {}
  for d in list(dicts) + [kwargs]:
    for k, v in d.items():
      if k in out:
        raise ValueError(f"key '{k}' appears twice")
      out[k] = v
  return out


def ordered_set(seq):
  """Deduplicate preserving order (reference :1073)."""
  return list(dict.fromkeys(seq))


def array_size(arr) -> int:
  """Total bytes of a numpy array (reference :47)."""
  import numpy as _np
  return int(_np.asarray(arr).nbytes)


def segment_list(l, size=None, n_seg=None):
  """Split a list into n_seg adaptive-size contiguous segments (the MPI
  job splitter, reference ``mpi.py:337``)."""
  import numpy as _np
  if n_seg is None:
    n_seg = int(_np.ceil(len(l) / float(size)))
  segments, start = [], 0
  remain_data, remain_seg = len(l), n_seg
  while remain_data > 0:
    size = remain_data // remain_seg
    segments.append(l[start:start + size])
    start += size
    remain_data -= size
    remain_seg -= 1
  return segments


def get_all_files(path, filter_func=None):
  """Recursive file listing with optional predicate (reference
  ``python_utils.py:478``)."""
  import os as _os
  out = []
  for root, _, files in _os.walk(path):
    for f in files:
      p = _os.path.join(root, f)
      if filter_func is None or filter_func(p):
        out.append(p)
  return sorted(out)


def get_all_ext(path):
  """All distinct file extensions under a tree (reference
  ``python_utils.py``)."""
  import os as _os
  exts = set()
  for p in get_all_files(path):
    e = _os.path.splitext(p)[1]
    if e:
      exts.add(e)
  return sorted(exts)


def select_path(*paths, default=None, create_new: bool = False):
  """First existing path; optionally create the first candidate
  (reference ``python_utils.py:670``)."""
  import os as _os
  for p in paths:
    p = _os.path.abspath(_os.path.expanduser(str(p)))
    if _os.path.exists(p):
      return p
  if create_new and paths:
    p = _os.path.abspath(_os.path.expanduser(str(paths[0])))
    _os.makedirs(p, exist_ok=True)
    return p
  if default is not None:
    return default
  raise ValueError(f"none of the paths exist: {paths}")


class classproperty:
  """@classproperty descriptor (reference ``python_utils.py:657``)."""

  def __init__(self, fget):
    self.fget = fget

  def __get__(self, obj, owner):
    return self.fget(owner)


class Singleton(type):
  """Metaclass: one instance per class (reference ``decorators.py:632``)."""

  _instances: dict = {}

  def __call__(cls, *args, **kwargs):
    if cls not in Singleton._instances:
      Singleton._instances[cls] = super().__call__(*args, **kwargs)
    return Singleton._instances[cls]


class UniqueHasher:
  """Deterministic collision-free label hasher (reference
  ``utils/__init__.py:444``): remembers assignments so every distinct value
  gets a distinct id, probing forward on collisions."""

  def __init__(self, nb_labels=None):
    self.nb_labels = nb_labels
    self._memory = {}        # hash_key -> value
    self._current_hash = {}  # value -> hash_key

  def hash(self, value):
    if value in self._current_hash:
      return self._current_hash[value]
    import hashlib
    key = int(hashlib.md5(str(value).encode()).hexdigest(), 16)
    if self.nb_labels is not None:
      key = key % self.nb_labels
      if len(self._memory) >= self.nb_labels:
        raise ValueError(f"all {self.nb_labels} labels assigned")
    while key in self._memory:
      key = (key + 1) % self.nb_labels if self.nb_labels else key + 1
    self._memory[key] = value
    self._current_hash[value] = key
    return key

  __call__ = hash


def catch_warnings_ignore(*categories):
  """Context manager silencing the given warning categories (reference
  ``python_utils.py:742``)."""
  import contextlib
  import warnings

  @contextlib.contextmanager
  def _cm():
    with warnings.catch_warnings():
      for c in (categories or (Warning,)):
        warnings.simplefilter("ignore", c)
      yield

  return _cm()


__all__ += ["uuid", "read_lines", "iter_chunk", "dict_union", "ordered_set",
            "array_size", "segment_list", "get_all_files", "get_all_ext",
            "select_path", "classproperty", "Singleton", "UniqueHasher",
            "catch_warnings_ignore"]


def get_figpath(*args, **kwargs) -> str:
  """Managed figures dir (reference ``utils/__init__.py:1170-1276``)."""
  import os as _os
  p = _os.path.join(get_exp_path(), "figures")
  _os.makedirs(p, exist_ok=True)
  return p


def get_logpath(*args, **kwargs) -> str:
  """Managed logs dir (reference managed paths)."""
  import os as _os
  p = _os.path.join(get_exp_path(), "logs")
  _os.makedirs(p, exist_ok=True)
  return p


def get_modelpath(*args, **kwargs) -> str:
  """Managed models dir (reference managed paths)."""
  import os as _os
  p = _os.path.join(get_exp_path(), "models")
  _os.makedirs(p, exist_ok=True)
  return p


def play_audio(data, fs: int, volumn: float = 1.0, speed: float = 1.0):
  """Play a waveform in a notebook (reference ``utils/__init__.py:1392``);
  IPython-gated — returns the Audio display object."""
  import numpy as _np
  try:
    from IPython.display import Audio
  except ImportError as e:  # pragma: no cover
    raise RuntimeError("play_audio needs IPython (notebook environment)") \
        from e
  y = _np.asarray(data, _np.float32) * float(volumn)
  return Audio(y, rate=int(fs * speed))


__all__ += ["get_figpath", "get_logpath", "get_modelpath", "play_audio"]
