"""The port's host utilities (``odin_tpu_torch.utils`` and its submodules)
against the JAX package's (``odin_tpu.utils``, which imports no JAX), each
public name on the same inputs.

``CASES`` maps a name to a function of one package's modules (``M.u`` the
package, ``M.<submodule>`` the others) that returns what the name gives on
fixed inputs: the two packages must return equal values.  Where a result
holds a time or a random draw, the case masks it (timings in the progress
bar's text) or seeds it (``uuid``, the AES salts come from ``os.urandom``, so
the ciphertexts are held by decrypting each package's with the other's).
No case touches the network: ``get_arxiv_titles`` reads a stubbed
``urllib.request.urlopen``.
"""
import abc
import importlib
import io
import os
import pickle
import random
import re
import sys
import types
import warnings
import zipfile
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

SUBMODULES = ("cli", "crypto", "decorators", "mpi", "np_utils",
              "ordered_flag", "pdf_utils", "progbar", "python_utils")


def _modules(pkg):
  ns = types.SimpleNamespace(u=importlib.import_module(f"{pkg}.utils"))
  for name in SUBMODULES:
    setattr(ns, name, importlib.import_module(f"{pkg}.utils.{name}"))
  return ns


JAX = _modules("odin_tpu")
PORT = _modules("odin_tpu_torch")


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path / "home"))
  monkeypatch.chdir(tmp_path)


def _equal(a, b):
  if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and
            a.dtype == b.dtype and a.shape == b.shape and
            np.array_equal(a, b))
  if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
    return type(a) is type(b) and len(a) == len(b) and all(
        _equal(x, y) for x, y in zip(a, b))
  if isinstance(a, dict) and isinstance(b, dict):
    return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
  return a == b


def _printed(fn):
  out, err = io.StringIO(), io.StringIO()
  with redirect_stdout(out), redirect_stderr(err):
    value = fn()
  return value, out.getvalue(), err.getvalue()


def _home_rel(path):
  return os.path.relpath(path, os.environ["ODIN_TPU_HOME"])


# -- utils/__init__.py --------------------------------------------------------
def _minibatch(M):
  x, y = np.arange(10), np.arange(10) * 2
  return ([list(M.u.minibatch(3, 10))],
          [list(M.u.minibatch(4, 10, shuffle=True, seed=1))],
          list(M.u.minibatch(4, None, x, y, shuffle=True, seed=2)),
          list(M.u.minibatch(3, None, x)))


def _unit_timer(M):
  def run():
    with M.u.UnitTimer("step") as t:
      pass
    return t.duration >= 0
  value, out, _ = _printed(run)
  return value, re.sub(r"[0-9.]+s", "Xs", out)


def _paths(M):
  return [_home_rel(f()) for f in (
      M.u.get_cache_path, M.u.get_data_path, M.u.get_exp_path,
      M.u.get_datasetpath, M.u.get_exppath, M.u.get_figpath,
      M.u.get_logpath, M.u.get_modelpath)]


def _squares(x, power=2):
  _squares.calls += 1
  return x ** power


def _cache_disk(M):
  _squares.calls = 0
  fn = M.u.cache_disk(_squares)
  got = [fn(3), fn(3), fn(4, power=3)]
  files = sorted(os.listdir(M.u.get_cache_path()))
  for f in files:
    os.remove(os.path.join(M.u.get_cache_path(), f))
  return got, _squares.calls, files


def _cache_memory(M):
  _squares.calls = 0
  fn = M.u.cache_memory(_squares)
  got = [fn(5), fn(5), fn(np.arange(3)), fn(np.arange(3))]
  fn.cache_clear()
  got.append(fn(5))
  return got, _squares.calls


def _status(M):
  system = M.u.get_system_status(scale_factor=1.0)
  process = M.u.get_process_status(os.getpid())
  return sorted(system), sorted(process), process["pid"], \
      system["cpu_count"]


def _progbar(M):
  """The bar's records, reports and summary text; times masked."""
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    bar = M.progbar.Progbar(target=4, name="fit", print_report=False)
  bar.set_summarizer("acc", lambda v: max(v))
  bar.set_labels(["a", "b"])
  for i in range(6):
    bar.add(1, loss=float(i), acc=i / 10, vec=np.arange(2) * i)
  bar["extra"] = 7
  _, out, err = _printed(lambda: (bar.add_notification("half"),
                                  M.progbar.add_notification("module")))
  text = re.sub(r"\d+\.\d+\(s\)|\d+\.\d+\(obj/s\)", "T", bar.summary)
  notes = re.sub(r"\[\d\d/\w+-\d\d:\d\d:\d\d\]", "[stamp]", out + err)
  bar.close()
  return (bar.epoch_idx, bar.nb_epoch, bar.seen, bar.labels, bar["loss"],
          bar.get_report(0), bar.get_report(-1, "loss"), bar.report(),
          {k: dict(v) for k, v in bar.history.items()}, text, notes)


def _arg_controller(M):
  c = (M.cli.ArgController("demo").add("-ds", "dataset", "mnist")
       .add("-bs", "batch", 32).add("--debug", "debug", False)
       .add("-opt", "optimizer", "adam", choices=("adam", "sgd")))
  return (vars(c.parse([])),
          vars(c.parse(["-ds", "cifar", "-bs", "8", "--debug", "-opt",
                        "sgd"])))


def _stdio(M):
  path = "stdio.log"
  out, err = io.StringIO(), io.StringIO()
  with redirect_stdout(out), redirect_stderr(err):
    with M.cli.stdio(path):
      print("to both")
      print("error line", file=sys.stderr)
    print("after")
  with open(path) as f:
    return f.read(), out.getvalue(), err.getvalue()


def _add_one(batch):
  return [j + 1 for j in batch]


def _mpi(M):
  runs = [M.mpi.MPI(list(range(7)), _add_one, ncpu=1, batch=b).run()
          for b in (1, 3)]
  gen = M.mpi.MPI(list(range(4)), lambda b: (x * 2 for x in b), ncpu=1,
                  batch=2).run()
  counter = M.mpi.SharedCounter(5)
  counts = [counter.add(), counter.add(3), counter.value]
  future = M.mpi.async_thread(lambda a, b=1: a * b, 6, b=7)
  return runs, gen, counts, future.get(timeout=10), len(M.mpi.MPI([1, 2],
                                                                  _add_one))


def _small_helpers(M):
  u = M.u
  ctext = u.ctext("x", "red")  # stdout is not a tty under pytest
  _, _, err = _printed(lambda: u.eprint("a", 1))

  class Obj(u.MD5object):
    def __init__(self):
      self.a, self.b = 1, [2, 3]

  return (u.flatten_list([1, [2, [3, (4,)]], 5]),
          u.flatten_list([1, [2, [3, (4,)]]], level=1), ctext, err,
          Obj().md5_checksum, u.as_tuple(3, 2), u.as_tuple([1], 3, float),
          u.as_tuple(np.arange(2)), u.md5_checksum(b"abc"),
          u.md5_checksum(np.arange(5)), u.md5_checksum({"k": (1, 2)}))


def _lists(M):
  u = M.u
  with open("lines.txt", "w") as f:
    f.write("a\n\n b \nc\n")
  os.makedirs("tree/sub", exist_ok=True)
  for name in ("tree/x.wav", "tree/sub/y.txt", "tree/sub/z.wav",
               "tree/noext"):
    open(name, "w").close()
  return (u.read_lines("lines.txt"), list(u.iter_chunk(range(7), 3)),
          u.dict_union({"a": 1}, {"b": 2}, c=3),
          u.ordered_set([3, 1, 3, 2, 1]), u.array_size(np.zeros((3, 4))),
          u.segment_list(list(range(10)), n_seg=3),
          u.segment_list(list(range(10)), size=4),
          [os.path.relpath(p) for p in u.get_all_files("tree")],
          [os.path.relpath(p) for p in u.get_all_files(
              "tree", lambda p: p.endswith(".wav"))],
          u.get_all_ext("tree"),
          os.path.relpath(u.select_path("missing", "tree")),
          os.path.relpath(u.select_path("made", create_new=True)),
          u.select_path("missing", default="dflt"))


def _dict_union_raises(M):
  with pytest.raises(ValueError, match="twice"):
    M.u.dict_union({"a": 1}, a=2)
  with pytest.raises(ValueError):
    M.u.select_path("missing")
  with pytest.raises(ValueError):
    M.u.as_tuple([1, 2], 3)
  return True


def _classes(M):
  u = M.u

  class A:
    x = 3

    @u.classproperty
    def double(cls):
      return cls.x * 2

  class S(metaclass=u.Singleton):
    def __init__(self, v=0):
      self.v = v

  h = u.UniqueHasher(nb_labels=5)
  labels = [h(v) for v in ("a", "b", "c", "a", "d")]
  h2 = u.UniqueHasher()
  with u.catch_warnings_ignore(UserWarning):
    with warnings.catch_warnings(record=True) as caught:
      warnings.warn("hidden", UserWarning)
  return (A.double, S(1) is S(2), S(3).v, labels, h2("zz") == h2("zz"),
          len(caught))


def _uuid(M):
  random.seed(7)
  return M.u.uuid(), M.u.uuid(12)


def _save_wav(M):
  y = np.sin(np.linspace(0, 50, 800)).astype(np.float32) * 0.5
  M.u.save_wav("out.wav", y, 8000)
  with open("out.wav", "rb") as f:
    return f.read()


def _play_audio(M):
  y = np.sin(np.linspace(0, 20, 400))
  audio = M.u.play_audio(y, 8000, volumn=0.5, speed=2.0)
  return type(audio).__name__, audio.data


# -- np_utils, ordered_flag, decorators, python_utils ------------------------
def _np_utils(M):
  n = M.np_utils
  a = np.arange(12, dtype=np.float16).reshape(3, 4)
  idx, labels = n.unique_labels(["b/1", "a/2", "b/3"],
                                key_func=n.label_splitter(0),
                                return_labels=True)
  plain = n.unique_labels([3, 1, 2])
  return (n.bytes2array(n.array2bytes(a)), n.array2bytes(a),
          n.one_hot(np.array([0, 2, -1]), 4), n.one_hot([[1], [0]]),
          M.u.one_hot([1, 0, 2]), labels, [idx(x) for x in ("a/9", "b/0")],
          plain.labels, plain(2), n.label_splitter(1, "_")((3, "a_b", "x")),
          pickle.loads(pickle.dumps(idx))("b/7"))


def _ordered_flag(M):
  class Kind(M.ordered_flag.OrderedFlag):
    A = "a"
    B = "b"
    C = "c"

  ab, ba = Kind.A | Kind.B, Kind.B | Kind.A
  return (ab.value, ba.value, ab == ba, Kind.A in ab, Kind.C in ab,
          (ab & Kind.B).value, (ab ^ Kind.C).value, (~Kind.A).value,
          [m.value for m in ba], ba.index(Kind.A), ba[0].value,
          Kind.parse("b").value, Kind.parse("zz", raise_not_found=False),
          hash(ab) == hash(ba), Kind("c_a").value)


def _decorators(M):
  d = M.decorators
  calls = []

  @d.schedule(0.0, max_repeat=2)
  def tick(i):
    calls.append(i)
    return i

  ticks = [tick(i) for i in range(4)]

  @d.typecheck
  def add(a: int, b: int) -> int:
    return a + b

  with pytest.raises(TypeError, match="expected int"):
    add(1, "2")

  class Model:
    @d.autoattr(fitted=True, size=lambda self: len(self.data))
    def fit(self, data):
      self.data = data
      return self

  class Base(abc.ABC):
    @d.abstractstatic
    def make():
      pass

  with pytest.raises(TypeError):
    Base()
  scale = 3
  fn = d.functionable(lambda x, y=1: (x + y) * scale, 2, y=5)
  clone = pickle.loads(pickle.dumps(fn))

  @d.singleton
  class Cache:
    def __init__(self, name):
      self.name = name

  m = Model().fit([1, 2, 3])
  return (ticks, calls, add(2, 3), m.fitted, m.size, fn(), clone(),
          clone(y=0), repr(fn).split(",")[1:], Cache("a") is Cache("a"),
          Cache("a") is Cache("b"))


def _python_utils(M):
  p = M.python_utils
  s = p.struct(a=1)
  s.b = 2
  s["c"] = 3
  b = p.bidict({"x": 1})
  b["y"] = 2
  f = p.fifodict(maxlen=2)
  for k in "abc":
    f[k] = k.upper()
  il = p.IndexedList([1, 2], names=["one", "two"])
  il.append(3, name="three")

  class Point:
    def __init__(self, x, y=0):
      self.xy = (x, y)

  stamp = p.get_formatted_datetime()
  pretty = p.get_formatted_datetime(only_number=False)
  return (dict(s), s.b, s.c, b["x"], b[2], dict(b.inv),
          p.defaultdictkey(str.upper)["ab"], dict(f), list(f.copy()),
          p.multikeysdict({("a", "b"): 1, "c": 2}),
          p.partialclass(Point, y=5)(1).xy, il["three"], il[0],
          len(stamp), stamp.isdigit(), len(pretty),
          p.get_function_arguments(lambda a, b=1, *c, d, **e: 0),
          [p.is_lambda(v) for v in (lambda: 0, len)],
          [p.is_pickleable(v) for v in (1, lambda: 0)],
          [p.is_number(v) for v in (1, 1.5, True, "2")],
          p.is_number("2.5", string_number=True),
          [p.is_string(v) for v in ("a", b"a")],
          [p.is_bool(v) for v in (True, np.bool_(0), 1)],
          [p.is_primitive(v) for v in ((1, "a"), [np.zeros(1)], {})],
          p.is_primitive(np.zeros(1), inc_ndarray=False),
          [p.is_path(v) for v in ("a/b", "tree_missing", os.getcwd())])


# -- crypto and pdf_utils -----------------------------------------------------
def _md5_folder(M):
  os.makedirs("folder/sub", exist_ok=True)
  for name, data in (("folder/a.bin", b"abc"), ("folder/sub/b.bin", b"xyz")):
    with open(name, "wb") as f:
      f.write(data)
  return M.crypto.md5_folder("folder"), M.crypto.to_password("pw", b"s" * 16)


def _sanitize(M):
  return [M.pdf_utils.sanitize_title(t) for t in (
      None, "  A\ntitle/with\\seps ", "Untitled doc", "")]


def _pdf(title):
  return (b"%PDF-1.4\n1 0 obj\n<< /Title " + title + b" >>\nendobj\n"
          b"trailer\n<< /Info 1 0 R >>\n%%EOF\n")


def _pdf_titles(M):
  os.makedirs("pdfs", exist_ok=True)
  for name, title in (("p1.pdf", b"(Deep \\(Nets\\))"),
                      ("p2.pdf", b"<FEFF0041004200430020>"),
                      ("p3.pdf", b"(Untitled)"), ("Deep (Nets).pdf",
                                                  b"(Deep \\(Nets\\))")):
    with open(os.path.join("pdfs", name), "wb") as f:
      f.write(_pdf(title))
  titles = {os.path.basename(k): v
            for k, v in M.pdf_utils.get_pdf_titles("pdfs").items()}
  stats, out, _ = _printed(lambda: M.pdf_utils.rename_pdf("pdfs",
                                                          dry_run=True))
  out = "\n".join(sorted(line.replace(os.path.abspath("pdfs"), "P")
                         for line in out.splitlines()))
  with pytest.raises(ImportError, match="pypdf"):
    M.pdf_utils.get_pdf_text("pdfs")
  return titles, stats, out, sorted(os.listdir("pdfs"))


ATOM = (b'<?xml version="1.0"?><feed xmlns="http://www.w3.org/2005/Atom">'
        b"<entry><title>First Paper</title></entry>"
        b"<entry><title>Second\n Paper</title></entry></feed>")


def _arxiv(M):
  import urllib.request
  asked = []

  class Reply(io.BytesIO):
    def __enter__(self):
      return self

    def __exit__(self, *exc):
      return False

  def urlopen(url, timeout=None):
    asked.append(url)
    return Reply(ATOM if "," in url else ATOM.split(b"<entry>")[0] +
                 b"<entry><title>Only</title></entry></feed>")

  real, urllib.request.urlopen = urllib.request.urlopen, urlopen
  try:
    return (M.pdf_utils.get_arxiv_titles(["1706.03762", "bad", "1312.6114"]),
            M.pdf_utils.get_arxiv_titles("1312.6114"), asked)
  finally:
    urllib.request.urlopen = real


CASES = {
    "minibatch": _minibatch, "UnitTimer": _unit_timer, "paths": _paths,
    "cache_disk": _cache_disk, "cache_memory": _cache_memory,
    "status": _status, "Progbar": _progbar,
    "ArgController": _arg_controller, "stdio": _stdio, "MPI": _mpi,
    "helpers": _small_helpers, "lists": _lists,
    "raises": _dict_union_raises, "classes": _classes, "uuid": _uuid,
    "save_wav": _save_wav, "play_audio": _play_audio,
    "np_utils": _np_utils, "OrderedFlag": _ordered_flag,
    "decorators": _decorators, "python_utils": _python_utils,
    "md5_folder": _md5_folder, "sanitize_title": _sanitize,
    "pdf_titles": _pdf_titles, "arxiv": _arxiv,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax(name, tmp_path):
  got = []
  for side, M in (("jax", JAX), ("port", PORT)):
    os.makedirs(tmp_path / side)
    os.chdir(tmp_path / side)
    got.append(CASES[name](M))
  assert _equal(*got), got


def test_async_process_matches_jax(tmp_path):
  """A forked process writes its file in both packages (run in a fresh
  Python: a fork inside a worker that has imported JAX may deadlock)."""
  code = "\n".join([
      "import importlib, os, sys",
      "sys.path.insert(0, os.getcwd())",
      "mpi = importlib.import_module(sys.argv[1] + '.utils.mpi')",
      "def write(path, text):",
      "  open(path, 'w').write(text)",
      "p = mpi.async_process(write, sys.argv[2], 'done')",
      "p.join(30)",
      "print(p.exitcode, open(sys.argv[2]).read())"])
  import subprocess
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  outs = [subprocess.run([sys.executable, "-c", code, pkg,
                          str(tmp_path / f"{pkg}.txt")], cwd=root,
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
          for pkg in ("odin_tpu", "odin_tpu_torch")]
  assert outs == ["0 done\n"] * 2


def test_every_name_of_jax_utils():
  """Every name of JAX's ``utils.__all__`` and of each submodule's
  ``__all__`` is in the port's, and ``odin_tpu_torch.mpi`` is
  ``odin_tpu_torch.utils.mpi``."""
  import odin_tpu_torch.mpi as top
  assert top is PORT.mpi and PORT.u.MPI is PORT.mpi.MPI
  assert set(JAX.u.__all__) <= set(PORT.u.__all__)
  for name in JAX.u.__all__:
    assert hasattr(PORT.u, name), name
  for sub in SUBMODULES:
    assert set(getattr(JAX, sub).__all__) <= set(getattr(PORT, sub).__all__)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_aes_crosses_packages(direction, tmp_path):
  """Data one package encrypts, the other decrypts: bytes, files, and a
  zipped folder; a wrong password is refused by both."""
  enc, dec = (PORT, JAX) if direction == "port_to_jax" else (JAX, PORT)
  data = os.urandom(3000)
  blob = enc.crypto.encrypt_aes(data, "secret")
  assert dec.crypto.decrypt_aes(blob, "secret") == data
  with pytest.raises(ValueError, match="wrong password"):
    dec.crypto.decrypt_aes(blob, "other")
  src = tmp_path / "plain.bin"
  src.write_bytes(data)
  enc.crypto.encrypt_aes(str(src), b"secret", outfile=str(tmp_path / "c"))
  dec.crypto.decrypt_aes(str(tmp_path / "c"), b"secret",
                         outfile=str(tmp_path / "back"))
  assert (tmp_path / "back").read_bytes() == data
  folder = tmp_path / "folder"
  (folder / "sub").mkdir(parents=True)
  (folder / "a.txt").write_text("alpha")
  (folder / "sub" / "b.txt").write_text("beta")
  enc.crypto.zip_aes(str(folder), str(tmp_path / "f.zip.aes"), "pw")
  dec.crypto.unzip_aes(str(tmp_path / "f.zip.aes"), str(tmp_path / "out"),
                       "pw")
  assert (tmp_path / "out" / "folder" / "a.txt").read_text() == "alpha"
  assert (tmp_path / "out" / "folder" / "sub" / "b.txt").read_text() == "beta"
  assert zipfile.is_zipfile(io.BytesIO(dec.crypto.decrypt_aes(
      (tmp_path / "f.zip.aes").read_bytes(), "pw")))
