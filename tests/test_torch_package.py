"""Package-level checks of the PyTorch port: it imports no jax, its copies
of the JAX package's host modules stay in sync with their originals, and
it never falls back from a device it was asked for."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from public_kssd_tpu_torch import kernels, resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "public_kssd_tpu")
PORT_PKG = os.path.join(REPO, "public_kssd_tpu_torch")

# host modules copied line for line; only the package name differs
VERBATIM = ["config", "formats", "infiles", "hashdedup",
            "combine", "setops", "reverse", "postproc"]

# copies that differ on purpose: the top-level definitions named here
# differ, every other definition the two files share must be identical
DIFFERING = {
    # builds its own copy of the C source, and native/kssd_print.c beside
    # it, into one library in build/public_kssd_tpu_torch/ under a
    # source-hash name, never loading the committed .so; binds the block
    # formatter (Names, dist_rows_buf) in place of the one-row writer
    # dist_row, which nothing in the port calls (Names also takes a
    # stattab.NameTable, whose fixed-width rows are its blob, so a search
    # prints its names with no loop over them); dedup_slot_order and
    # dedup_counts run the sparse twins of native/kssd_dedup.c (the same
    # bytes; memory and work follow the stream, not hashsize) over a map
    # of the filled slots (_slot_map), built into the same library
    # (_DEDUP_SRC, _SOURCES); get_lib builds and loads (_load) under a
    # lock (_LOCK), so a thread that calls it during another's build
    # waits for that build and gets the library; the scanners return a
    # view of their output array, not a copy, and scan a writable array
    # in place (fasta_codes_in_place, fastq_codes_in_place, _writable);
    # adds the port's gzip inflater, native/kssd_inflate.c, built into
    # the same library (_INFLATE_SRC), bound as gzip_member (one member
    # between addresses, its INFLATE_* result codes) and crc32; the
    # original has no inflater of its own; the FASTA scanners' wrappers
    # (fasta_to_codes, fasta_codes_in_place) call the port's own vector
    # scanner, native/kssd_scan.c's kssd_fasta_scan (_SCAN_SRC), which
    # gives kssd_fasta_to_codes' symbols 16-32 bytes a step
    "native/__init__": {"_so_path", "_build", "get_lib", "_SRC", "_SO",
                        "_ROOT", "_HERE", "BUILD_DIR", "_CFLAGS", "_PRINT_SRC",
                        "Names", "dist_rows_buf", "dist_row",
                        "_DEDUP_SRC", "_SOURCES", "_slot_map",
                        "dedup_slot_order", "dedup_counts", "_load", "_LOCK",
                        "fasta_to_codes", "fastq_to_codes", "_writable",
                        "fasta_codes_in_place", "fastq_codes_in_place",
                        "_INFLATE_SRC", "gzip_member", "crc32", "_SCAN_SRC"},
    # a small file's bytes land in one array and are scanned there
    # (read_codes): the port's own inflater (native/kssd_inflate.c through
    # native.gzip_member, _inflate_kssd; _KSSD = False turns it off),
    # else libdeflate, else the system zlib through ctypes
    # (_load_libz, _LIBZ), inflates gzip members straight into it,
    # reading the input at address offsets (inflate, inflate_route,
    # _grown, _inflate_libdeflate, _inflate_libz, _DEFLATE_MAX_RATIO,
    # _GZIP_MAGIC; _load_libdeflate binds the buffers as addresses), so a
    # multi-member file costs O(n) and nothing is copied under the GIL;
    # gzip_decompress is a wrapper over inflate. Every route stops where
    # the members end by one rule (_next_member, _END, _BAD): the
    # original's on the same host (libdeflate's where it is loaded,
    # gzip.decompress's otherwise); the bytes and the gzip module's
    # fallback are the original's. fasta_to_codes_py (the scanner of
    # hosts without a compiler) also closes a header at the end of an
    # input that holds no newline, where the original raises IndexError
    "seqio": {"_load_libdeflate", "_load_libz", "_LIBZ", "_DEFLATE_MAX_RATIO",
              "_GZIP_MAGIC", "inflate", "inflate_route", "_next_member",
              "_grown", "_inflate_kssd", "_inflate_libdeflate", "_inflate_libz",
              "gzip_decompress", "read_codes", "fasta_to_codes_py"},
    # write_distance_out formats blocks of lines on -p threads through
    # native/kssd_print.c and writes them in query order (print_threads,
    # print_blocks, _write_native and their constants); its Python
    # branch and every formula are the original's
    "ops/stats": {"write_distance_out", "print_threads", "print_blocks",
                  "_write_native", "PRINT_BUFFER_BYTES", "BLOCKS_PER_THREAD",
                  "LINE_BYTES"},
    # logger renamed; profile_trace records a torch.profiler trace (CPU +
    # CUDA) instead of jax.profiler; adds TracedStageTimer, a StageTimer
    # whose stages are also torch.profiler.record_function spans, so a
    # trace's idle gaps carry the host stage around them
    "utils": {"log", "profile_trace", "TracedStageTimer"},
    # adds feistel_torch, the int64 tensor twin of feistel; detect takes
    # a device and, on a card, compares the whole table there
    # (_matches_feistel_torch, in steps of _CHECK_CHUNK entries) instead
    # of building it in numpy; its spot-check and its CPU path are the
    # original's
    "shufspace": {"feistel_torch", "_M32", "detect", "_matches_feistel_torch",
                  "_CHECK_CHUNK"},
    # looks for the real GTDB size file relative to the working
    # directory, not at the original's absolute path
    "synthdb": {"REAL_GTDB_INDEX"},
    # the device joins run csrc/join.cu (no capacity retry, no
    # DEVICE_JOIN_THRESHOLD auto-selection, device=None is the host
    # oracle); the dense -s search is torch; --mesh runs
    # parallel/sharded_composite on a torch device mesh; the CSR route
    # (species_abundance, _csr_stats_device) reads its index straight
    # onto the device (index.load_device_index) and takes DeviceIndex
    # components; the device routes build the query table and reduce the
    # hit keys on the device (_query_table_device, _hits_to_stats_torch,
    # one key range after another past the device's free memory), so
    # _query_table and _hits_to_stats stay the host oracles; the raw
    # route (species_abundance, _batched_stats_device) reads the DB's
    # combco files straight onto the device (_raw_device_components) and
    # makes each join chunk's genome ids there (_genome_ids);
    # species_abundance reads its stat files through stattab (names
    # decoded only where the report writes them), each file once
    "composite": {
        "DEVICE_JOIN_THRESHOLD", "_batched_join_impl", "_BATCH_JOIN",
        "_batched_join_fn", "_csr_join_impl", "_CSR_JOIN", "_csr_join_fn",
        "_overflow_retry", "_batched_stats_device", "_csr_stats_device",
        "species_abundance", "abv_search_device", "cmd_composite",
    },
    # torch.distributed instead of jax.distributed, its group destroyed
    # at exit (_destroy_at_exit); stage I on a torch device
    "parallel/distributed": {"initialize", "_destroy_at_exit", "sketch_shard"},
    # ragged shards on a torch device mesh, counted by csrc/count.cu's
    # 64-bit-key instances: no padding, rank tables, pair capacity,
    # shard_map step or 22-bit collective planes. The shards are built
    # on the slots' devices from the index directory (device_shards,
    # DeviceShards and its helpers: the index read in bounded groups of
    # row ranges through index.CsrSlices, each group folded into one CSR,
    # the genome split, the code cut found by buckets of the code, the
    # assembly), the query keys sliced on the device (DeviceQueries) and
    # each count block fetched into place through pinned staging
    # (_fetch); the numpy construction (ShardedDB, merge_components,
    # query_keys, build_sharded_db, build_genome_sharded_db) has no copy
    # in the port: the tests hold the device construction to it
    "parallel/sharded_search": {
        "ShardedDB", "merge_components", "query_keys", "build_sharded_db",
        "build_genome_sharded_db",
        "_attach_buckets", "_window_search", "_rowgather_lookup",
        "_count_partial", "_count_partial_pair", "make_sharded_count_fn",
        "sharded_search_counts", "estimate_capacity", "_sharded_count_block",
        "device_shards", "DeviceShards", "DeviceQueries", "CUT_BUCKET_BITS",
        "_fold", "_ragged", "_assemble", "_folded", "_row_of", "_genome_pieces",
        "_code_pieces", "_cut_keys", "_fetch",
    },
    # ragged position shards joined by csrc/join.cu's 64-bit-key
    # instance: no pad key, no capacity retry; each slot reads and folds
    # its slice of the DB on its device (_slot_db) and the query table
    # is made on the device (_fold_queries_device); the hit statistics
    # run on the first local slot's device
    # (composite._hits_to_stats_torch); the host folds (FOLD_SHIFT,
    # _fold_ref, _fold_queries, _shard_db) have no copy in the port: the
    # tests hold the device folds to them
    "parallel/sharded_composite": {
        "_PAD_KEY", "FOLD_SHIFT", "_fold_ref", "_fold_queries", "_shard_db",
        "_make_join_fn", "species_abundance_sharded", "_slot_db",
        "_fold_queries_device",
    },
}

# modules of DIFFERING that share no definition with the JAX package's:
# the port builds on the device what the original builds in numpy
SHARES_NOTHING = {"parallel/sharded_search", "parallel/sharded_composite"}


def _read(pkg, mod):
    with open(os.path.join(pkg, mod + ".py")) as f:
        return f.read()


@pytest.mark.parametrize("mod", VERBATIM)
def test_host_module_copy_is_verbatim(mod):
    orig = _read(JAX_PKG, mod).splitlines()
    port = _read(PORT_PKG, mod).replace("public_kssd_tpu_torch", "public_kssd_tpu")
    assert port.splitlines() == orig


@pytest.mark.parametrize("path", ["native/kssd_host.c"])
def test_host_source_copy_is_byte_equal(path):
    """Non-Python sources the port builds from are its own byte-equal
    copies of the JAX package's."""
    with open(os.path.join(JAX_PKG, path), "rb") as f:
        orig = f.read()
    with open(os.path.join(PORT_PKG, path), "rb") as f:
        assert f.read() == orig and orig


def _top_level(src):
    """name -> ast dump of each top-level def, class and assignment."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node)
    return out


@pytest.mark.parametrize("mod", sorted(DIFFERING))
def test_differing_copy_shares_the_rest(mod):
    orig = _top_level(_read(JAX_PKG, mod))
    port = _top_level(
        _read(PORT_PKG, mod).replace("public_kssd_tpu_torch", "public_kssd_tpu")
    )
    shared = (set(orig) & set(port)) - DIFFERING[mod]
    assert bool(shared) != (mod in SHARES_NOTHING), mod
    for name in sorted(shared):
        assert orig[name] == port[name], f"{mod}.{name} drifted"
    assert set(orig) - set(port) <= DIFFERING[mod]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import public_kssd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'public_kssd_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: resolve_device('cuda') succeeds")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")


def test_cli_default_device_raises_without_card(tmp_path):
    """kssd_torch dist defaults to --device cuda and does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from public_kssd_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["dist", "-L", "3", "-o", str(tmp_path / "x"), str(tmp_path)])


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error carrying its reason, not a
    fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    k = kernels.CudaKernel("sketch", "kssd_sketch", [])
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        k.function()
    assert k.launches == 0


def test_kernel_sources_and_build_dir():
    """Every kernel builds from csrc/ into build/public_kssd_tpu_torch/,
    under a name keyed by the source and flags, for sm_90a; the narrow
    and the wide sketch kernels share one library, the four counting
    kernels (plain and koc, 32-bit codes and 64-bit keys) another, and
    the two composite joins a third."""
    assert kernels.sketch_wide_kernel.so_path() == kernels.sketch_kernel.so_path()
    for k in (kernels.count_koc_kernel, kernels.count64_kernel,
              kernels.count_koc64_kernel):
        assert k.so_path() == kernels.count_kernel.so_path()
    assert kernels.join64_kernel.so_path() == kernels.join_kernel.so_path()
    assert kernels.join_kernel.source == os.path.join(PORT_PKG, "csrc", "join.cu")
    assert [k.name for k in kernels.ALL] == [
        "sketch", "sketch_wide", "count", "count_koc", "join", "count64",
        "count_koc64", "join64",
    ]
    assert len({k.so_path() for k in kernels.ALL}) == 3
    assert kernels.BUILD_DIR == os.path.join(REPO, "build", "public_kssd_tpu_torch")
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for k in kernels.ALL:
        assert os.path.isfile(k.source)
        assert k.source.startswith(os.path.join(PORT_PKG, "csrc"))
        assert os.path.dirname(k.so_path()) == kernels.BUILD_DIR
        with open(k.source) as f:
            src = f.read()
        assert f'extern "C" int {k.entry}(' in src
        assert "cudaGetLastError()" in src


def test_native_helper_builds_from_its_own_source():
    from public_kssd_tpu_torch import native

    assert native._SRC == os.path.join(PORT_PKG, "native", "kssd_host.c")
    assert native._PRINT_SRC == os.path.join(PORT_PKG, "native", "kssd_print.c")
    assert native._DEDUP_SRC == os.path.join(PORT_PKG, "native", "kssd_dedup.c")
    assert native._INFLATE_SRC == os.path.join(PORT_PKG, "native", "kssd_inflate.c")
    assert native._SCAN_SRC == os.path.join(PORT_PKG, "native", "kssd_scan.c")
    assert native._SOURCES == (native._SRC, native._PRINT_SRC, native._DEDUP_SRC,
                               native._INFLATE_SRC, native._SCAN_SRC)
    lib = native.get_lib()
    assert lib is not None
    assert lib.kssd_dist_rows_buf and lib.kssd_fasta_to_codes
    assert lib.kssd_dedup_slot_order_sparse and lib.kssd_dedup_counts_sparse
    assert lib.kssd_gzip_inflate and lib.kssd_crc32
    assert lib.kssd_fasta_scan and lib.kssd_fasta_scan_at
    assert os.path.dirname(native._so_path()) == os.path.join(
        REPO, "build", "public_kssd_tpu_torch"
    )


@pytest.mark.parametrize("suffix", [".fa", ".fa.gz", ".fa.bz2"])
def test_read_codes_scans_with_the_ports_scanner(tmp_path, monkeypatch, suffix):
    """seqio.read_codes reaches kssd_scan.c's kssd_fasta_scan once a file
    (in place for a plain and a gzip file, into a new array for bz2) and
    never kssd_fasta_to_codes: the library behind native's wrappers is
    replaced by one that counts the two scanners' calls."""
    import bz2
    import gzip

    from public_kssd_tpu_torch import native, seqio

    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    body = b">a genome\n" + b"ACGTTGCAacgtNNNN" * 500 + b"\n>b\r\n" + b"GATTACA\n" * 300
    path = tmp_path / f"g{suffix}"
    path.write_bytes({".fa": body, ".fa.gz": gzip.compress(body),
                      ".fa.bz2": bz2.compress(body)}[suffix])
    want = seqio.fasta_to_codes_py(body)
    calls = []

    class Counting:
        def __getattr__(self, name):
            return getattr(lib, name)

        def kssd_fasta_scan(self, *args):
            calls.append("kssd_fasta_scan")
            return lib.kssd_fasta_scan(*args)

        def kssd_fasta_to_codes(self, *args):
            calls.append("kssd_fasta_to_codes")
            return lib.kssd_fasta_to_codes(*args)

    monkeypatch.setattr(native, "get_lib", Counting)
    got = seqio.read_codes(str(path))
    assert calls == ["kssd_fasta_scan"]
    assert got.tobytes() == want.tobytes() and want.size > 8000


def test_native_helper_first_use_from_many_threads(tmp_path, monkeypatch):
    """Eight threads reach get_lib() together on a build directory with
    no library in it: the first builds, the rest wait for that build,
    and every one gets the same loaded library (none gets None and a
    slower fallback)."""
    import threading

    from public_kssd_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not os.path.exists(native._so_path())
    start = threading.Barrier(8)
    got = [None] * 8

    def call(i):
        start.wait()
        got[i] = native.get_lib()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[0] is not None and all(lib is got[0] for lib in got)
    assert os.path.isfile(native._so_path())
    assert got[0]._name == native._so_path()


def _reads_jax_package(src: str) -> list[int]:
    """Lines of calls that take a string naming a path under
    public_kssd_tpu/ (os.path.join(..., "public_kssd_tpu", ...),
    open("public_kssd_tpu/...")); comments and docstrings are not calls."""
    lines = []
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.Call):
            continue
        for arg in node.args:
            if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                    and "public_kssd_tpu" in arg.value.split("/")):
                lines.append(node.lineno)
    return lines


def test_port_reads_no_file_of_the_jax_package():
    assert _reads_jax_package(
        'import os\n"""cites public_kssd_tpu/native/kssd_host.c"""\n'
        'p = os.path.join(r, "public_kssd_tpu", "native", "kssd_host.c")\n'
        'open("public_kssd_tpu/x.c")\n'
    ) == [3, 4]
    found = {}
    for dirpath, _, files in os.walk(PORT_PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    lines = _reads_jax_package(f.read())
                if lines:
                    found[os.path.relpath(path, REPO)] = lines
    assert not found, found
