"""Where a fresh ``kssd_torch`` process's start goes.

Every ``kssd_torch`` command a user runs is a fresh process, which pays
for the interpreter, torch's import, the port's imports and CUDA's start
before its stages run. ``fresh_runs`` runs a CLI command N times, each in
a fresh process through this file's child mode (``--child``): it imports
``public_kssd_tpu_torch.cli`` and calls ``main`` with the command's
arguments, as ``python3 -m public_kssd_tpu_torch.cli`` does, with probes
that read the host clock (``time.monotonic``, one clock for every
process of the host) and do nothing else:

* an import hook times the execution of ``torch`` and of each module of
  the port (``import torch``; ``port_imports``: the port's modules less
  the modules they import);
* wrappers time the port's steps where the tree has them: ``main``,
  argument parsing (to the command's function), the file listing,
  ``resolve_device`` (``torch.cuda.is_available``,
  ``torch.cuda.current_device``), the ``.shuf`` read
  (``formats.read_shuf``) and check (``shufspace.detect``), each parse of
  stage I's pool (``pipeline.parse_one``), each staging set
  (``ops.staging.Staging``), each kernel library's load
  (``CudaKernel.library``) and each kernel's first launch, the native
  helper's load, the stage functions (``run_stage1``, ``run_stage2``,
  ``search``) and, on a tree that brings the card up on a thread
  (``public_kssd_tpu_torch.start``), that thread's steps and the main
  thread's wait for it;
* on a tree without that thread, the first device allocation
  (``torch.empty(1)`` and a synchronize, which creates the context) is
  made right after the first ``resolve_device`` of a card, so that its
  cost shows on its own: the same work the tree does at its first device
  call, moved to where it can be timed.

Once ``main`` has returned, the child ends one of three ways
(``ENDS``, ``--end``): "close_out" calls the CLI's ``close_out``, as
its ``entry`` does for a user (the default on a tree that has one);
"interpreter" returns to the interpreter's exit, as the CLI did before;
"sync_exit" synchronizes the card and calls ``os._exit``. The exit's
steps are written as they end (``_probe_exit``): the close-out up to its
``os._exit``, ``threading._shutdown`` and the threads it joins, each
``atexit`` handler by name, the rest of the interpreter's finalization
and, from the last Python-visible point to the parent's ``waitpid``,
the libraries' static destructors and the kernel's teardown
(``exit_split``).

Each run gives its wall (spawn to exit, on this process's clock), the
pieces above in seconds (``pieces``: the first span of each; ``exit``:
from ``main``'s return to the process's end; ``exit.*``: its steps),
how it ended (``exit``: the way and the joined threads), the times a few events
came, counted from the spawn (``at``), the stage seconds the command
logged, every span (``spans``: name, thread, start and end from the
spawn), its peak resident memory (``max_rss_mb``, /proc/<pid>/statm
every 5 ms) split into anonymous and file-backed memory at the peak
(``rss_at_peak``, /proc/<pid>/smaps_rollup read as the peak rises), and
the resident memory by mapping at ``main``'s return (``rss_by_mapping``,
/proc/self/smaps). ``summary`` gives each piece's median over the runs.

``--overlap N`` runs, N times each in fresh processes, the start of a
process that imports torch and reaches the card, in six ways
(``overlap_child``; ``--ways`` picks some): ``serial`` (``import
torch``, then ``torch.zeros(1, device="cuda")``); ``cuinit_thread``
(``cuInit`` and ``cuDevicePrimaryCtxRetain`` of the first card through
ctypes on ``libcuda.so.1`` on a thread while the main thread imports
torch, then the first allocation); ``torch_thread`` (torch imported,
the first allocation on a thread while the main thread runs a Python
loop: the loop's longest stall says how long the thread held the
interpreter lock); ``cuinit_gil`` (``cuInit`` and the context on a thread
beside the same loop); ``prefetch_first`` (the shared libraries a
process maps once it has imported torch, ``torch_libraries``, read once
on 8 threads, then ``import torch``) and ``prefetch_beside`` (the same
reads on 8 threads while the main thread imports torch): whether torch's
import waits on reading its libraries, and whether reading them ahead
helps.

``--compare N --parent DIR -- <kssd_torch arguments>`` runs the command
in fresh processes in turns (``compare``): the parent checkout DIR's
port, this one's, and this one's ending through the interpreter's exit;
N rounds after an untimed one, with each way's median wall less the
parent's over the rounds. ``--exit N -- <kssd_torch arguments>`` runs
this checkout's port ending each of the three ways in turns
(``exit_ways``). ``--import-split`` times ``import torch`` by module
(``-X importtime``), reads the loader's statistics and checks torch's
``__pycache__`` (``import_split``). ``--reread FILE`` summarizes again
the runs in turns that an ``--out`` FILE holds (``summary``,
``minus_first``).

Run from the checkout's root, on a card::

    python3 tools/fresh_start.py --overlap 5 [--out FILE]
    python3 tools/fresh_start.py --compare 10 --parent DIR [--clean PATH] -- dist ...
    python3 tools/fresh_start.py --exit 10 [--clean PATH] -- dist ...
    python3 tools/fresh_start.py --import-split
    python3 tools/fresh_start.py --reread FILE

``tools/print_spans.py --fresh N`` and ``tools/stage1_spans.py --fresh
N`` run their cells' commands through ``fresh_runs``.
"""

from __future__ import annotations

import time

T_ENTER = time.monotonic()

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib.abc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "public_kssd_tpu_torch"

# ------------------------------------------------------------- the child


class Spans:
    """[name, thread, start, end] of every probed call, on the host's
    monotonic clock."""

    def __init__(self):
        self.spans: list[list] = []
        self.lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self.lock:
            self.spans.append([name, threading.current_thread().name, t0, t1])

    def wrap(self, owner, attr: str, label) -> None:
        """Time every call of ``owner.attr`` (when it exists) under
        ``label`` (a string, or a function of the call's arguments)."""
        fn = owner.__dict__.get(attr) if isinstance(owner, type) else getattr(
            owner, attr, None)
        if fn is None or getattr(fn, "_probed", False):
            return

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                self.add(label if isinstance(label, str) else label(*a, **k),
                         t0, time.monotonic())

        timed._probed = True
        setattr(owner, attr, timed)


def _library_label(kernel, *_a, **_k) -> str:
    return "library " + os.path.splitext(os.path.basename(kernel.source))[0]


def _launch_label(kernel, *_a, **_k) -> str:
    return "launch " + kernel.name


def _patch(spans: Spans, name: str, module, state: dict) -> None:
    """The probes of module ``name``, once it has run; ``state`` holds
    whether the context is still to be probed and the logged lines."""
    w = spans.wrap
    if name == "torch":
        w(module.cuda, "is_available", "torch.cuda.is_available")
        w(module.cuda, "current_device", "torch.cuda.current_device")
    elif name == PORT:
        real = module.resolve_device

        @functools.wraps(real)
        def resolve(dev_name):
            t0 = time.monotonic()
            dev = real(dev_name)
            spans.add("resolve_device", t0, time.monotonic())
            if dev.type == "cuda" and state["context_probe"]:
                state["context_probe"] = False  # once, on a tree without the start thread
                import torch

                t0 = time.monotonic()
                torch.empty(1, device=dev)
                torch.cuda.synchronize(dev)
                spans.add("context", t0, time.monotonic())
            return dev

        module.resolve_device = resolve
    elif name == f"{PORT}.cli":
        w(module, "main", "main")
        for cmd in ("_cmd_dist", "_cmd_shuffle"):
            w(module, cmd, "command")
        w(module, "_load_params", "load_params")
    elif name == f"{PORT}.infiles":
        w(module, "organize_infiles", "file_listing")
        w(module, "organize_infile_list", "file_listing")
    elif name == f"{PORT}.formats":
        w(module, "read_shuf", "shuf_read")
        w(module, "read_mco_stat", "stat_read")
        w(module, "read_co_stat", "stat_read")
    elif name == f"{PORT}.shufspace":
        w(module, "detect", "detect")
    elif name == f"{PORT}.pipeline":
        w(module, "parse_one", "parse_one")
        w(module, "run_stage1", "run_stage1")
    elif name == f"{PORT}.index":
        w(module, "run_stage2", "run_stage2")
        w(module, "load_device_index", "load_device_index")
    elif name == f"{PORT}.search":
        w(module, "search", "search")
    elif name == f"{PORT}.ops.staging":
        w(module.Staging, "__init__", "staging")
        w(module, "prepare", "staging.prepare")
    elif name == f"{PORT}.kernels":
        w(module.CudaKernel, "library", _library_label)
        w(module.CudaKernel, "launch", _launch_label)
    elif name == f"{PORT}.native":
        w(module, "get_lib", "native.get_lib")
    elif name == f"{PORT}.utils":
        import logging

        class Keep(logging.Handler):
            def emit(self, record):
                state["logged"].append(record.getMessage())

        module.log.addHandler(Keep())
    elif name == f"{PORT}.start":
        w(module, "_cuinit", "start.cuinit")
        w(module, "_context", "start.context")
        w(module.CardStart, "_run", "start.thread")
        w(module.CardStart, "join", "start.join")


class _ImportTimer(importlib.abc.MetaPathFinder):
    """Times the execution of ``torch`` and of the port's modules, and
    probes each when it has run."""

    def __init__(self, spans: Spans, state: dict):
        self.spans = spans
        self.state = state

    def find_spec(self, name, path, target=None):
        if name != "torch" and name.split(".")[0] != PORT:
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(name, path, target)
            if spec is not None:
                break
        else:
            return None
        loader = spec.loader
        run = loader.exec_module

        def exec_module(module):
            t0 = time.monotonic()
            try:
                run(module)
            finally:
                self.spans.add("import " + name, t0, time.monotonic())
            _patch(self.spans, name, module, self.state)

        loader.exec_module = exec_module  # a loader serves one spec
        return spec


def rss_by_mapping(pid: str = "self", top: int = 12) -> dict:
    """Resident MiB by mapping (a file's name, [heap], [anon] ...) from
    /proc/<pid>/smaps: the ``top`` largest, and the anonymous and
    file-backed totals."""
    by: dict[str, float] = {}
    anon = 0.0
    name = "[anon]"
    with open(f"/proc/{pid}/smaps") as f:
        for line in f:
            head = line.split(None, 5)
            if head and not head[0].endswith(":"):
                name = os.path.basename(head[5].strip()) if len(head) > 5 else "[anon]"
                name = name or "[anon]"
            elif head[0] == "Rss:":
                by[name] = by.get(name, 0.0) + int(head[1]) / 1024
            elif head[0] == "Anonymous:":
                anon += int(head[1]) / 1024
    total = sum(by.values())
    return {"rss_mb": total, "anonymous_mb": anon, "file_or_device_mb": total - anon,
            "largest": dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])}


class _Marks:
    """Exit steps written to a file as they end (``name``, start, end and
    an extra field, tab-separated), with ``os.write``: the process may
    end with ``os._exit`` or after its modules are torn down, past any
    point where a buffered write or json would still run."""

    def __init__(self, path: str):
        self.fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self.write, self.clock = os.write, time.monotonic

    def add(self, name: str, t0: float, t1: float | None = None, extra: str = "") -> None:
        t1 = self.clock() if t1 is None else t1
        self.write(self.fd, ("%s\t%.9f\t%.9f\t%s\n" % (name, t0, t1, extra)).encode())

    def point(self, name: str, extra: str = "") -> None:
        t = self.clock()
        self.add(name, t, t, extra)


class _LastMark:
    """Kept as an attribute of ``sys``, which the interpreter clears
    after every other module: its ``__del__`` is the last Python-visible
    point of the interpreter's exit."""

    def __init__(self, marks: _Marks):
        self.marks = marks

    def __del__(self):
        self.marks.point("finalized")


def _probe_exit(marks: _Marks) -> None:
    """Time each step of this process's exit into ``marks``:
    ``threading._shutdown`` (``threads``, with the threads it joins),
    each ``atexit`` handler registered from now on (``atexit``, with its
    qualified name), the end of the handlers (``atexit_end``, a handler
    registered first, so that it runs after them), the interpreter's
    last Python-visible point (``finalized``) and a call of
    ``os._exit``."""
    import atexit

    marks.point("early_atexit", str(atexit._ncallbacks()))  # these run after atexit_end
    atexit.register(lambda: marks.point("atexit_end"))  # runs after the later ones
    real_register, real_unregister = atexit.register, atexit.unregister
    wrapped: dict = {}

    def register(fn, *a, **k):
        name = f"{getattr(fn, '__module__', None)}.{getattr(fn, '__qualname__', fn)}"

        def run():
            t0 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                marks.add("atexit", t0, extra=name)

        wrapped.setdefault(fn, []).append(run)
        real_register(run)
        return fn

    def unregister(fn):
        for run in wrapped.pop(fn, []):
            real_unregister(run)
        real_unregister(fn)

    atexit.register, atexit.unregister = register, unregister
    real_shutdown = threading._shutdown

    def shutdown():
        me = threading.current_thread()
        names = [th.name for th in threading.enumerate()
                 if th is not me and not th.daemon and th.is_alive()]
        t0 = time.monotonic()
        try:
            return real_shutdown()
        finally:
            marks.add("threads", t0, extra=",".join(names))

    threading._shutdown = shutdown
    real_exit = os._exit

    def _exit(code):
        marks.point("os._exit")
        real_exit(code)

    os._exit = _exit
    sys._kssd_last_mark = _LastMark(marks)


# the ways a probed process ends once ``main`` has returned
ENDS = ("interpreter", "close_out", "sync_exit")


def child(out: str, argv: list[str], end: str | None = None) -> int:
    """Run ``kssd_torch <argv>`` in this fresh process, probed; write the
    spans to ``out`` and the exit's steps to ``out``.exit. Then end as
    ``end`` says: "interpreter" returns the code to the interpreter's
    exit (``sys.exit(main())``, the CLI's end before its ``entry``);
    "close_out" calls the CLI's ``close_out``, the end its ``entry``
    gives a user (the default on a tree that has it, else
    "interpreter"); "sync_exit" waits for the card
    (``torch.cuda.synchronize()``, where CUDA was started) and calls
    ``os._exit`` at once."""
    spans = Spans()
    marks = _Marks(out + ".exit")
    _probe_exit(marks)
    spec = importlib.util.find_spec(PORT)
    # a tree that brings the card up itself has start.py
    state = {"logged": [], "context_probe": not os.path.isfile(
        os.path.join(os.path.dirname(spec.origin), "start.py"))}
    sys.meta_path.insert(0, _ImportTimer(spans, state))
    cli = importlib.import_module(f"{PORT}.cli")
    end = end or ("close_out" if hasattr(cli, "close_out") else "interpreter")
    if end == "close_out" and not hasattr(cli, "close_out"):
        raise SystemExit(f"{PORT}.cli has no close_out")
    rc = 1
    try:
        rc = cli.main(argv)
    finally:
        t_end = time.monotonic()
        sys.stdout.flush()
        t_map = time.monotonic()
        mapping = rss_by_mapping()
        with open(out, "w") as f:
            json.dump({"t_enter": T_ENTER, "t_main_end": t_end,
                       "probe_s": time.monotonic() - t_map, "rc": rc, "end": end,
                       "spans": spans.spans, "logged": state["logged"],
                       "rss_by_mapping": mapping}, f)
    if end == "close_out":
        marks.point("close_out")
        return cli.close_out(rc)
    if end == "sync_exit":
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        os._exit(rc)
    return rc


# ------------------------------------------------------------ the parent


def resident_mb(pid) -> float | None:
    """A process's resident MiB now (/proc/<pid>/statm); None once it
    has exited."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
    except (FileNotFoundError, ProcessLookupError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def rollup(pid) -> dict | None:
    """/proc/<pid>/smaps_rollup's Rss, Anonymous and file-backed MiB."""
    try:
        with open(f"/proc/{pid}/smaps_rollup") as f:
            text = f.read()
    except (FileNotFoundError, ProcessLookupError):
        return None
    kb = {m[0]: int(m[1]) for m in re.findall(r"^(\w+):\s+(\d+) kB", text, re.M)}
    if "Rss" not in kb:
        return None
    return {"rss_mb": kb["Rss"] / 1024, "anonymous_mb": kb.get("Anonymous", 0) / 1024,
            "file_mb": kb.get("Pss_File", 0) / 1024,
            "shmem_mb": kb.get("Pss_Shmem", 0) / 1024,
            "file_or_device_mb": (kb["Rss"] - kb.get("Anonymous", 0)) / 1024}


_STAGES = re.compile(r"(\w+): ([0-9.]+)s")


def logged_stages(lines: list[str]) -> dict[str, float]:
    """The stage seconds of the logged ``stage I:`` and ``search:`` lines
    (their bracketed timer reports)."""
    out: dict[str, float] = {}
    for line in lines:
        if line.startswith(("stage I:", "search:")) and "[" in line:
            for k, v in _STAGES.findall(line[line.rindex("["):]):
                out[k] = out.get(k, 0.0) + float(v)
    return out


def _exclusive(spans: list[list], prefix: str) -> float:
    """Seconds inside spans named ``prefix``... less the recorded spans
    nested in them on the same thread (an import's own time)."""
    own = [s for s in spans if s[0].startswith(prefix)]
    imports = [s for s in spans if s[0].startswith("import ")]
    total = 0.0
    for name, th, a, b in own:
        inner = [s for s in imports if s[1] == th and a <= s[2] and s[3] <= b
                 and s[2:] != [a, b]]
        # only the outermost nested spans
        top = [s for s in inner if not any(o is not s and o[2] <= s[2] and s[3] <= o[3]
                                           for o in inner)]
        total += (b - a) - sum(s[3] - s[2] for s in top)
    return total


def exit_split(res: dict, t_exit: float) -> tuple[dict, list[str]]:
    """The exit's steps, in seconds, from the child's marks (``_probe_exit``):
    ``exit.return`` (from the probe's write to the first step: the return
    through the interpreter, or ``sync_exit``'s synchronize),
    ``exit.close_out`` (the CLI's close-out up to its ``os._exit``),
    ``exit.threads`` (``threading._shutdown``), ``exit.atexit`` (the
    handlers; ``exit.atexit <name>`` each), ``exit.finalize`` (from the
    handlers' end to the last Python-visible point: module teardown, the
    garbage collection, and the handlers registered before the probe)
    and ``exit.teardown`` (from the last Python-visible point to the
    parent's ``waitpid``: the static destructors of the libraries and
    the kernel's teardown of the process); and the names of the threads
    ``threading._shutdown`` joined."""
    marks = [(m[0], float(m[1]), float(m[2]), m[3]) for m in res.get("exit_marks", [])]
    p: dict[str, float] = {}
    joined: list[str] = []
    start = res["t_main_end"] + res["probe_s"]
    first = min((m[1] for m in marks if m[0] != "early_atexit"), default=None)
    if first is not None:
        p["exit.return"] = first - start
    by = {m[0]: m for m in marks}
    if "close_out" in by and "os._exit" in by:
        p["exit.close_out"] = by["os._exit"][1] - by["close_out"][1]
    if "threads" in by:
        p["exit.threads"] = by["threads"][2] - by["threads"][1]
        joined = [n for n in by["threads"][3].split(",") if n]
        if "atexit_end" in by:
            p["exit.atexit"] = by["atexit_end"][2] - by["threads"][2]
    for name, a, b, extra in marks:
        if name == "atexit":
            key = f"exit.atexit {extra}"
            p[key] = p.get(key, 0.0) + (b - a)
    if "atexit_end" in by and "finalized" in by:
        p["exit.finalize"] = by["finalized"][1] - by["atexit_end"][2]
    last = by.get("os._exit") or by.get("finalized")
    if last is not None:
        p["exit.teardown"] = t_exit - last[1]
    return p, joined


def pieces(res: dict, t_spawn: float, t_exit: float) -> tuple[dict, dict]:
    """The run's pieces (seconds) and event times (seconds from the
    spawn)."""
    spans = res["spans"]
    main_th = "MainThread"

    def first(name, thread=None):
        for s in spans:
            if s[0] == name and (thread is None or s[1] == thread):
                return s
        return None

    def dur(s):
        return None if s is None else s[3] - s[2]

    p: dict[str, float | None] = {
        "interpreter": res["t_enter"] - t_spawn,
        "import_torch": dur(first("import torch")),
        "port_imports": _exclusive(spans, f"import {PORT}"),
        "main": dur(first("main")),
    }
    main, cmd = first("main"), first("command")
    p["args"] = None if main is None or cmd is None else cmd[2] - main[2]
    p["file_listing"] = sum(dur(s) for s in spans if s[0] == "file_listing") or None
    for name in ("resolve_device", "torch.cuda.is_available", "torch.cuda.current_device",
                 "context", "start.cuinit", "start.context", "start.thread",
                 "start.join", "staging", "staging.prepare", "native.get_lib",
                 "shuf_read", "detect", "load_params", "stat_read",
                 "load_device_index", "run_stage1", "run_stage2", "search"):
        p[name] = dur(first(name))
    for s in spans:
        if s[0].startswith(("library ", "launch ")) and s[0] not in p:
            p[s[0]] = dur(s)
    parses = sorted((s for s in spans if s[0] == "parse_one"), key=lambda s: s[3])
    p["first_genome"] = dur(parses[0]) if parses else None
    stages = logged_stages(res["logged"])
    p["stages_sum"] = sum(stages.values()) or None
    p["exit"] = t_exit - res["t_main_end"] - res["probe_s"]
    p["wall"] = t_exit - t_spawn
    at = {}
    for key, s in (("torch_imported", first("import torch")), ("detect_end", first("detect")),
                   ("start_end", first("start.thread")), ("main_end", main),
                   ("context_end", first("context") or first("start.context"))):
        if s is not None:
            at[key] = s[3] - t_spawn
    if parses:
        at["first_genome_end"] = parses[0][3] - t_spawn
        at["first_genome_start"] = parses[0][2] - t_spawn
        det = first("detect")
        if det is not None:
            at["genomes_parsed_before_detect_end"] = sum(s[3] <= det[3] for s in parses)
    th = first("start.thread")
    if th is not None:
        wait = sum(dur(s) for s in spans if s[0] == "start.join" and s[1] == main_th)
        at["start_hidden_s"] = dur(th) - wait  # the start's time the main thread did not wait
    return p, {**at, "stages": stages}


def fresh_runs(argv: list[str], n: int, timeout: float = 900,
               clean: str | None = None, root: str = ROOT,
               end: str | None = None) -> list[dict]:
    """``kssd_torch <argv>`` in ``n`` fresh processes through the probed
    child, with the port of the checkout ``root``: each one's wall,
    pieces (the exit's steps among them, ``exit_split``), events, spans,
    memory, and how it ended (``exit``: the way, ``child``'s ``end``, and
    the threads the interpreter's exit joined). ``clean`` (a path) is
    removed after each run."""
    env = dict(os.environ, PYTHONPATH=root)
    flags = ["--end", end] if end else []
    runs = []
    for _ in range(n):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "spans.json")
            with open(os.path.join(tmp, "err"), "w+") as err:
                t_spawn = time.monotonic()
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--child", out, *flags,
                     "--", *argv],
                    cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err)
                peak, at_peak, last_roll = 0.0, None, 0.0
                while proc.poll() is None:
                    now = resident_mb(proc.pid) or 0.0
                    if now > peak:
                        peak = now
                        if time.monotonic() - last_roll > 0.025:
                            at_peak = rollup(proc.pid) or at_peak
                            last_roll = time.monotonic()
                    if time.monotonic() - t_spawn > timeout:
                        proc.kill()
                    time.sleep(0.005)
                t_exit = time.monotonic()
                err.seek(0)
                log = err.read()
            if proc.returncode != 0 or not os.path.isfile(out):
                raise RuntimeError(f"kssd_torch {' '.join(argv)} exited "
                                   f"{proc.returncode}: {log[-2000:]}")
            with open(out) as f:
                res = json.load(f)
            with open(out + ".exit") as f:
                res["exit_marks"] = [line.rstrip("\n").split("\t") for line in f]
        p, at = pieces(res, t_spawn, t_exit)
        split, joined = exit_split(res, t_exit)
        p.update(split)
        runs.append({"wall_s": t_exit - t_spawn, "pieces": p, "at": at,
                     "exit": {"end": res.get("end"), "joined": joined},
                     "max_rss_mb": peak, "rss_at_peak": at_peak,
                     "rss_by_mapping": res["rss_by_mapping"],
                     "spans": [[s[0], s[1], round(s[2] - t_spawn, 6),
                                round(s[3] - t_spawn, 6)] for s in res["spans"]]})
        if clean:
            shutil.rmtree(clean, ignore_errors=True)
    return runs


def after_import(run: dict) -> float:
    """A run's wall less its ``import torch``: what the port controls."""
    return run["wall_s"] - (run["pieces"].get("import_torch") or 0.0)


def summary(runs: list[dict]) -> dict:
    """Walls, their median, the median of the walls less ``import torch``
    (``after_import``), and the median of each piece over the runs that
    have it."""
    keys = sorted({k for r in runs for k, v in r["pieces"].items() if v is not None})
    med = {k: statistics.median(v) for k in keys
           if (v := [r["pieces"][k] for r in runs if r["pieces"].get(k) is not None])}
    stages = sorted({k for r in runs for k in r["at"]["stages"]})
    return {"walls_s": [r["wall_s"] for r in runs],
            "median_wall_s": statistics.median(r["wall_s"] for r in runs),
            "median_after_import_torch_s": statistics.median(map(after_import, runs)),
            "median_pieces_s": med,
            "median_stages_s": {k: statistics.median(r["at"]["stages"].get(k, 0.0)
                                                     for r in runs) for k in stages},
            "max_rss_mb": [r["max_rss_mb"] for r in runs]}


# ------------------------------------------------------ the start, 4 ways

_LOOP_SLICE = 0.0005


def _busy(until) -> dict:
    """A Python loop on this thread until ``until()`` is true: its
    longest stall between two turns and the seconds lost to stalls of
    over 1 ms (another thread holding the interpreter lock)."""
    t = time.monotonic()
    longest = lost = 0.0
    start = t
    while not until():
        now = time.monotonic()
        gap = now - t
        longest = max(longest, gap)
        if gap > 0.001:
            lost += gap
        t = now
    return {"loop_s": time.monotonic() - start, "longest_stall_s": longest,
            "stalled_s": lost}


def _cuinit_start(ordinal: int = 0) -> None:
    """cuInit and the primary context of card ``ordinal`` through the
    C API of ``libcuda.so.1`` (ctypes releases the interpreter lock in each
    call)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    for call, args in (("cuInit", (0,)), ("cuDeviceGet", (ctypes.byref(dev), ordinal)),
                       ("cuDevicePrimaryCtxRetain", (ctypes.byref(ctx), dev))):
        err = getattr(cuda, call)(*args)
        if err != 0:
            raise RuntimeError(f"{call} returned CUresult {err}")


def torch_libraries() -> list[str]:
    """The shared libraries a process maps once it has imported torch
    (/proc/self/maps of a fresh process), largest first."""
    code = ("import torch, json\n"
            "paths = {l.split()[-1] for l in open('/proc/self/maps') if '.so' in l}\n"
            "print(json.dumps(sorted(p for p in paths if p.startswith('/'))))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       check=True, timeout=600)
    paths = json.loads(r.stdout.strip().splitlines()[-1])
    return sorted(paths, key=os.path.getsize, reverse=True)


def read_files(paths: list[str], threads: int = 8) -> float:
    """Seconds for ``threads`` threads to read every file of ``paths``
    once (each read releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    def read(path: str) -> int:
        n = 0
        buf = bytearray(16 << 20)
        with open(path, "rb", buffering=0) as f:
            while got := f.readinto(buf):
                n += got
        return n

    t = time.monotonic()
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(read, paths))
    return time.monotonic() - t


def overlap_child(way: str, libs: list[str] | None = None) -> dict:
    """One fresh process's start, ``way`` (see the module's docstring);
    seconds of each step."""
    out: dict = {"way": way}
    t0 = time.monotonic()
    out["interpreter_s"] = t0 - T_ENTER
    if way == "prefetch_first":
        out["prefetch_s"] = read_files(libs)
        t = time.monotonic()
        import torch  # noqa: F401

        out["import_torch_s"] = time.monotonic() - t
    elif way == "prefetch_beside":
        span = {}
        th = threading.Thread(target=lambda: span.update(s=read_files(libs)))
        th.start()
        t = time.monotonic()
        import torch  # noqa: F401

        out["import_torch_s"] = time.monotonic() - t
        th.join()
        out["prefetch_s"] = span["s"]
    elif way in ("serial", "torch_thread"):
        t = time.monotonic()
        import torch

        out["import_torch_s"] = time.monotonic() - t
        if way == "serial":
            t = time.monotonic()
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            out["cuda_start_s"] = time.monotonic() - t
        else:
            done = threading.Event()
            span = {}

            def start():
                t = time.monotonic()
                torch.zeros(1, device="cuda")
                torch.cuda.synchronize()
                span["s"] = time.monotonic() - t
                done.set()

            th = threading.Thread(target=start)
            th.start()
            out["main_loop"] = _busy(done.is_set)
            th.join()
            out["cuda_start_s"] = span["s"]
    elif way == "cuinit_thread":
        span = {}

        def drive():
            t = time.monotonic()
            _cuinit_start()
            span["s"] = time.monotonic() - t

        th = threading.Thread(target=drive)
        th.start()
        t = time.monotonic()
        import torch

        out["import_torch_s"] = time.monotonic() - t
        t = time.monotonic()
        th.join()
        out["join_wait_s"] = time.monotonic() - t
        out["cuinit_s"] = span["s"]
        t = time.monotonic()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        out["cuda_after_cuinit_s"] = time.monotonic() - t
    elif way == "cuinit_gil":
        done = threading.Event()
        span = {}

        def drive():
            t = time.monotonic()
            _cuinit_start()
            span["s"] = time.monotonic() - t
            done.set()

        th = threading.Thread(target=drive)
        th.start()
        out["main_loop"] = _busy(done.is_set)
        th.join()
        out["cuinit_s"] = span["s"]
    else:
        raise ValueError(way)
    out["total_s"] = time.monotonic() - t0
    return out


WAYS = ("serial", "cuinit_thread", "torch_thread", "cuinit_gil", "prefetch_first",
        "prefetch_beside")


def overlap_runs(n: int, ways=WAYS) -> dict:
    """Each of ``ways`` n times, in turns, each in a fresh process; the
    spawn-to-exit wall beside each. The prefetch ways read the libraries
    of ``torch_libraries`` (listed once, in a process of its own)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out: dict = {w: [] for w in ways}
    libs = torch_libraries() if any(w.startswith("prefetch") for w in ways) else []
    out["libraries"] = {"files": len(libs),
                        "bytes": sum(os.path.getsize(p) for p in libs)}
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(libs, f)
    try:
        for _ in range(n):
            for way in ways:
                out[way].append(_overlap_run(way, f.name, env))
    finally:
        os.remove(f.name)
    return out


def _overlap_run(way: str, libs: str, env: dict) -> dict:
    """One fresh process of ``way``: its steps and its spawn-to-exit wall."""
    t = time.monotonic()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--overlap-child", way, "--libs", libs], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t
    if r.returncode != 0:
        raise RuntimeError(f"{way} exited {r.returncode}: {r.stderr[-2000:]}")
    return {**json.loads(r.stdout.strip().splitlines()[-1]), "wall_s": wall}


def in_turns(argv: list[str], n: int, ways: dict[str, dict],
             clean: str | None = None) -> dict:
    """``kssd_torch <argv>`` in fresh processes, each way of ``ways`` (its
    name, and ``fresh_runs``' keyword arguments) in turns: one untimed
    round first (it builds each checkout's kernels), then ``n`` rounds of
    one run of each, the order turned by one each round. Each way's
    summary and runs."""
    names = list(ways)
    runs: dict[str, list] = {w: [] for w in names}
    for i in range(n + 1):
        turn = names[i % len(names):] + names[:i % len(names)]
        for w in turn:
            run = fresh_runs(argv, 1, clean=clean, **ways[w])[0]
            if i:
                runs[w].append(run)
    return {w: {**summary(r), "runs": r} for w, r in runs.items()}


def compare(argv: list[str], n: int, parent: str, clean: str | None = None) -> dict:
    """``in_turns`` of three ways: the port of the checkout ``parent``,
    this checkout's (each ending as its CLI's entry ends), and this
    checkout's ending through the interpreter's exit, each against the
    parent round by round (``minus_first``)."""
    return minus_first(in_turns(
        argv, n, {"parent": {"root": parent}, "change": {},
                  "change, the interpreter's exit": {"end": "interpreter"}}, clean))


def minus_first(out: dict) -> dict:
    """``out`` (``in_turns``' result) with, for each way after the first,
    the median over the rounds of its wall less the first way's wall in
    the same round (``median_minus_<first way>_s``), the same for the
    walls less ``import torch`` (``..._after_import_torch_s``: torch's
    import varies by seconds from one process to the next), and the
    rounds where it was the lower of each."""
    names = [w for w, r in out.items() if isinstance(r, dict) and "runs" in r]
    base = out[names[0]]["runs"]
    for w in names[1:]:
        for tag, of in (("", lambda r: r["wall_s"]), ("_after_import_torch", after_import)):
            diffs = [of(a) - of(b) for a, b in zip(out[w]["runs"], base)]
            out[w][f"median_minus_{names[0]}{tag}_s"] = statistics.median(diffs)
            out[w][f"rounds_below_{names[0]}{tag}"] = sum(d < 0 for d in diffs)
    return out


def in_turn_lines(argv: list[str], out: str, exit_n: int, compare_n: int,
                  parent: str | None) -> list[dict]:
    """A cell's ``exit_ways`` (``exit_n`` rounds) and ``compare`` against
    the checkout ``parent`` (``compare_n`` rounds) of ``argv``, which
    writes ``out``: a result line for each asked for, its rounds under
    "exit_ways" or "compare"."""
    lines = []
    if exit_n:
        lines.append({"exit_ways": exit_n, **exit_ways(argv, exit_n, out)})
    if compare_n:
        lines.append({"compare": compare_n, **compare(
            argv, compare_n, os.path.abspath(parent), out)})
    return lines


def without_runs(line: dict) -> dict:
    """A result line of ``in_turns`` without each way's runs (``--out``
    keeps them)."""
    return {k: {kk: vv for kk, vv in v.items() if kk != "runs"} if isinstance(v, dict)
            else v for k, v in line.items()}


def exit_ways(argv: list[str], n: int, clean: str | None = None) -> dict:
    """``in_turns`` of this checkout's port ending each way of ``ENDS``,
    with each way's exit split (``exit_split``) in its summary's
    ``median_pieces_s`` and its wall against the interpreter's exit's
    (``minus_first``)."""
    return minus_first(in_turns(argv, n, {e: {"end": e} for e in ENDS}, clean))


_IMPORTTIME = re.compile(r"import time:\s+(\d+) \|\s+(\d+) \| (\s*)(\S+)")


def import_split(top: int = 10) -> dict:
    """Where ``import torch`` goes, in fresh processes of this host:
    ``python3 -X importtime -c "import torch"`` twice in a row (each run's
    wall, torch's cumulative seconds and the ``top`` largest self times),
    ``LD_DEBUG=statistics`` of the same import (the dynamic loader's
    lines: its start-up time and relocations, and the final relocation
    counts, dlopen's included), and torch's ``__pycache__``: whether it
    exists and may be written, and how many ``.pyc`` files torch's tree
    held before these imports and after them. Then the import's wall as
    this host runs it, and twice with bytecode written to and read from
    a cache of its own (``-X pycache_prefix``, ``PYTHONDONTWRITEBYTECODE``
    unset): the first compiles every module it imports and writes it,
    the second reads what the first wrote."""
    spec = importlib.util.find_spec("torch")
    tree = os.path.dirname(spec.origin)

    def pycs() -> dict:
        n, newest = 0, 0.0
        for d, _, files in os.walk(tree):
            for f in files:
                if f.endswith(".pyc"):
                    n += 1
                    newest = max(newest, os.path.getmtime(os.path.join(d, f)))
        return {"pyc_files": n, "newest_pyc_mtime": newest}

    before = pycs()
    runs = []
    for _ in range(2):
        t = time.monotonic()
        r = subprocess.run([sys.executable, "-X", "importtime", "-c", "import torch"],
                           capture_output=True, text=True, timeout=600, check=True)
        wall = time.monotonic() - t
        rows = [(int(m[1]) / 1e6, int(m[2]) / 1e6, m[4]) for line in r.stderr.splitlines()
                if (m := _IMPORTTIME.match(line))]
        runs.append({"wall_s": wall,
                     "torch_cumulative_s": next((c for _, c, name in rows if name == "torch"),
                                                None),
                     "self_s_sum": sum(x for x, _, _ in rows),
                     "largest_self_s": [[name, x, c] for x, c, name in
                                        sorted(rows, key=lambda r: -r[0])[:top]]})
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-c",
                        "import sys, torch; print(bool(sys.flags.dont_write_bytecode))"],
                       capture_output=True, text=True, timeout=600, check=True,
                       env=dict(os.environ, LD_DEBUG="statistics"))
    loader = {"wall_s": time.monotonic() - t,
              "lines": [line.split(":", 1)[1].strip() for line in r.stderr.splitlines()
                        if re.match(r"\s*\d+:\s+\S", line)]}
    cache = os.path.join(tree, "__pycache__")
    def wall(flags: list[str], env) -> float:
        t = time.monotonic()
        subprocess.run([sys.executable, *flags, "-c", "import torch"], env=env,
                       capture_output=True, timeout=600, check=True)
        return time.monotonic() - t

    bytecode = {"as_run_s": wall([], os.environ)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    with tempfile.TemporaryDirectory() as prefix:
        bytecode["own_cache_s"] = [wall(["-X", f"pycache_prefix={prefix}"], env)
                                   for _ in range(2)]
        bytecode["pyc_written"] = sum(f.endswith(".pyc") for _, _, fs in os.walk(prefix)
                                      for f in fs)
    return {"importtime": runs, "ld_debug_statistics": loader, "bytecode": bytecode,
            "pycache": {"dir": cache, "exists": os.path.isdir(cache),
                        "writable": os.access(cache if os.path.isdir(cache) else tree,
                                              os.W_OK),
                        "dont_write_bytecode": r.stdout.strip() == "True",
                        "before": before, "after": pycs()}}


def gpu_name() -> str | None:
    """nvidia-smi's "name, power limit" of the first card; None without
    nvidia-smi."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
    except FileNotFoundError:
        return None
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        cut = argv.index("--")
        flags = argv[2:cut]
        return child(argv[1], argv[cut + 1:], flags[1] if flags[:1] == ["--end"] else None)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--overlap", type=int, default=0)
    ap.add_argument("--overlap-child", choices=WAYS, help=argparse.SUPPRESS)
    ap.add_argument("--libs", help=argparse.SUPPRESS)
    ap.add_argument("--ways", default=",".join(WAYS),
                    help="the ways of --overlap, comma-separated [all]")
    ap.add_argument("--compare", type=int, default=0,
                    help="rounds of compare() of the command after --")
    ap.add_argument("--exit", type=int, default=0,
                    help="rounds of exit_ways() of the command after --")
    ap.add_argument("--import-split", action="store_true",
                    help="where import torch goes (import_split())")
    ap.add_argument("--reread", metavar="FILE",
                    help="summarize again the runs of the ways in turns that "
                    "an --out FILE (of this tool, print_spans or stage1_spans) holds")
    ap.add_argument("--parent", help="the parent checkout for --compare")
    ap.add_argument("--clean", help="a path --compare removes after each run")
    ap.add_argument("--out", default=None)
    command = []
    if "--" in argv:
        command = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    args = ap.parse_args(argv)
    if args.overlap_child:
        libs = None
        if args.libs:
            with open(args.libs) as f:
                libs = json.load(f)
        print(json.dumps(overlap_child(args.overlap_child, libs)))
        return 0
    if args.reread:
        with open(args.reread) as f:
            for line in map(json.loads, f):
                ways = {w: {**summary(r["runs"]), "runs": r["runs"]} for w, r in line.items()
                        if isinstance(r, dict) and "runs" in r}
                if ways:
                    print(json.dumps(without_runs(minus_first(ways))), flush=True)
        return 0
    lines = []
    if args.compare:
        res = compare(command, args.compare, os.path.abspath(args.parent), args.clean)
        lines.append({"compare": command, **res})
        print(json.dumps(without_runs(lines[-1])), flush=True)
    if args.exit:
        res = exit_ways(command, args.exit, args.clean)
        lines.append({"exit": command, **res})
        print(json.dumps(without_runs(lines[-1])), flush=True)
    if args.overlap:
        lines.append({"overlap": overlap_runs(args.overlap, args.ways.split(","))})
        print(json.dumps(lines[-1]), flush=True)
    if args.import_split:
        lines.append({"import_split": import_split()})
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"gpu": gpu_name(), "host_cpus": len(os.sched_getaffinity(0))})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
