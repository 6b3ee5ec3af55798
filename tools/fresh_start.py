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

Each run gives its wall (spawn to exit, on this process's clock), the
pieces above in seconds (``pieces``: the first span of each; ``exit``:
from ``main``'s return to the process's end), the times a few events
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
port, this one's, and this one's with the card's start skipping its
cuInit step; N rounds after an untimed one, with each way's median wall
less the parent's over the rounds.

Run from the checkout's root, on a card::

    python3 tools/fresh_start.py --overlap 5 [--out FILE]
    python3 tools/fresh_start.py --compare 10 --parent DIR [--clean PATH] -- dist ...

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
        if state.get("skip_cuinit"):
            module._fresh = lambda: False
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


def child(out: str, argv: list[str], skip_cuinit: bool = False) -> int:
    """Run ``kssd_torch <argv>`` in this fresh process, probed; write the
    spans to ``out``."""
    spans = Spans()
    spec = importlib.util.find_spec(PORT)
    # a tree that brings the card up itself has start.py
    state = {"logged": [], "skip_cuinit": skip_cuinit, "context_probe": not os.path.isfile(
        os.path.join(os.path.dirname(spec.origin), "start.py"))}
    sys.meta_path.insert(0, _ImportTimer(spans, state))
    cli = importlib.import_module(f"{PORT}.cli")
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
                       "probe_s": time.monotonic() - t_map, "rc": rc,
                       "spans": spans.spans, "logged": state["logged"],
                       "rss_by_mapping": mapping}, f)
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
               skip_cuinit: bool = False) -> list[dict]:
    """``kssd_torch <argv>`` in ``n`` fresh processes through the probed
    child, with the port of the checkout ``root``: each one's wall,
    pieces, events, spans and memory. ``clean`` (a path) is removed after
    each run. ``skip_cuinit`` has the card's start skip its cuInit step
    (``start._fresh`` made false), so that torch starts CUDA on the start
    thread after its import, as without that step."""
    env = dict(os.environ, PYTHONPATH=root)
    flags = ["--skip-cuinit"] if skip_cuinit else []
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
        p, at = pieces(res, t_spawn, t_exit)
        runs.append({"wall_s": t_exit - t_spawn, "pieces": p, "at": at,
                     "max_rss_mb": peak, "rss_at_peak": at_peak,
                     "rss_by_mapping": res["rss_by_mapping"],
                     "spans": [[s[0], s[1], round(s[2] - t_spawn, 6),
                                round(s[3] - t_spawn, 6)] for s in res["spans"]]})
        if clean:
            shutil.rmtree(clean, ignore_errors=True)
    return runs


def summary(runs: list[dict]) -> dict:
    """Walls, their median, and the median of each piece over the runs
    that have it."""
    keys = sorted({k for r in runs for k, v in r["pieces"].items() if v is not None})
    med = {k: statistics.median(v) for k in keys
           if (v := [r["pieces"][k] for r in runs if r["pieces"].get(k) is not None])}
    stages = sorted({k for r in runs for k in r["at"]["stages"]})
    return {"walls_s": [r["wall_s"] for r in runs],
            "median_wall_s": statistics.median(r["wall_s"] for r in runs),
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


def compare(argv: list[str], n: int, parent: str, clean: str | None = None) -> dict:
    """``kssd_torch <argv>`` in fresh processes, three ways in turns: the
    port of the checkout ``parent``, this checkout's, and this
    checkout's with the card's start skipping its cuInit step
    (``fresh_runs``' ``skip_cuinit``). One untimed round first (it builds
    each checkout's kernels), then ``n`` rounds of one run of each, the
    order turned by one each round. Each way's runs and summary, and the
    median over the rounds of each way's wall less the parent's in the
    same round."""
    ways = {"parent": {"root": parent}, "change": {},
            "change, no cuInit step": {"skip_cuinit": True}}
    names = list(ways)
    runs: dict[str, list] = {w: [] for w in names}
    for i in range(n + 1):
        turn = names[i % len(names):] + names[:i % len(names)]
        for w in turn:
            run = fresh_runs(argv, 1, clean=clean, **ways[w])[0]
            if i:
                runs[w].append(run)
    out = {w: {**summary(r), "runs": r} for w, r in runs.items()}
    for w in names[1:]:
        out[w]["median_minus_parent_s"] = statistics.median(
            a["wall_s"] - b["wall_s"] for a, b in zip(runs[w], runs["parent"]))
    return out


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
        return child(argv[1], argv[cut + 1:], "--skip-cuinit" in argv[2:cut])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--overlap", type=int, default=0)
    ap.add_argument("--overlap-child", choices=WAYS, help=argparse.SUPPRESS)
    ap.add_argument("--libs", help=argparse.SUPPRESS)
    ap.add_argument("--ways", default=",".join(WAYS),
                    help="the ways of --overlap, comma-separated [all]")
    ap.add_argument("--compare", type=int, default=0,
                    help="rounds of compare() of the command after --")
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
    lines = []
    if args.compare:
        res = compare(command, args.compare, os.path.abspath(args.parent), args.clean)
        lines.append({"compare": command, **res})
        print(json.dumps({"compare": command, **{
            w: {k: v for k, v in r.items() if k != "runs"} for w, r in res.items()}}),
            flush=True)
    if args.overlap:
        lines.append({"overlap": overlap_runs(args.overlap, args.ways.split(","))})
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
