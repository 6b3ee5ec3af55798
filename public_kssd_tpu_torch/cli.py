"""Command-line interface of the PyTorch port: the reference kssd's
subcommands, with the arguments of ``public_kssd_tpu.cli`` plus
``--device`` where a command runs device work.

    kssd_torch shuffle   -k -s -l -o                 (command_shuffle.c:33-41)
    kssd_torch dist      sketch / index / search     (command_dist_wrapper.c:41-65)
    kssd_torch set       -u -q -s -i -c -g -P -o     (command_set.c:35-47)
    kssd_torch reverse   -L -o -b                    (command_reverse.c:35-42)
    kssd_torch composite -q [-b] / -i / -s / -d      (command_composite.c)
    kssd_torch convert   composite report -> Krona / QIIME / CAMI (src/*.pl)
    kssd_torch primer    (hidden) the largest prime below 2^i, i = 8..51

Dispatch logic mirrors dist_dispatch (command_dist.c:53-192):

  dist -r <raw seqs>  -o out          sketch refs + build index into out
  dist -r <co+mco dir> -o out <qry>   search query co dir vs reference db
  dist -o out <raw seqs>              sketch queries into out
  dist -o out <co dir>                build index (stage II) into out
  dist -o out <co dir> <co dir> ...   combine query sketch dirs

plus the sharded paths of ``public_kssd_tpu.cli``: ``dist --mesh DPxREF
[--shard-strategy genome|code]`` (search over a device mesh),
``composite --mesh N``, and ``dist --shard I:N`` / ``--merge-shards``
(stage I in shards, merged); ``dist --profile DIR`` writes a
torch.profiler trace of the whole command into DIR.

``--device cuda`` (the default) runs the window pass, the counting (with
``--koc-out`` also the abundance-weighted counting) and the composite
join in the hand-written kernels (csrc/) and raises when no card is
visible; ``--device cpu`` runs their plain PyTorch versions. ``--mesh``
on cuda takes the first visible cards and exits when there are fewer; on
cpu it repeats the CPU. ``set``, ``reverse``, ``convert`` and ``primer``
are host work in both packages and take no ``--device``.

A ``dist`` command that runs work on a card starts the card on a thread
(``start.CardStart``) before torch is imported, and waits for it just
before its first device call; stage I's parse pool starts as soon as the
input files are listed, before the ``.shuf`` is read and checked.

The ``kssd_torch`` command (``entry``) ends its process as soon as a
command has returned its exit code and its outputs are closed
(``close_out``): it skips the interpreter's exit (joining threads, the
``atexit`` handlers, module teardown and the static destructors of torch
and of the kernel libraries). Any other end (``sys.exit`` with a message,
an exception, a failed flush of stdout, a live torch.distributed group)
goes through the interpreter's exit as before. ``main`` returns its code
to in-process callers.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

_DEVICE_HELP = (
    "torch device of the kernels: cuda runs the hand-written kernels, "
    "cpu their plain PyTorch versions [cuda]"
)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kssd_torch",
        description="k-mer substring-space sketching (kssd-compatible) on "
        "PyTorch with CUDA kernels",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("shuffle", help="shuffle/sampling k-mer substring space")
    p.add_argument("-k", type=int, default=8, help="half k-mer length [8]")
    p.add_argument("-s", type=int, default=5, help="half substring length [5]")
    p.add_argument("-l", type=int, default=2, help="dim-reduction level [2]")
    p.add_argument("-o", default="./default", help="output file prefix")
    p.add_argument("--seed", type=int, default=None, help="RNG seed (reproducible)")
    p.add_argument("--random-perm", action="store_true",
                   help="Fisher-Yates table like the reference (the default "
                   "is a computed Feistel permutation: identical .shuf "
                   "format, gather-free sketching)")

    p = sub.add_parser("dist", help="sketching and distance estimation")
    p.add_argument("-k", type=int, default=8, help="half k-mer length [8]")
    p.add_argument("-p", type=int, default=0,
                   help="threads formatting distance.out [0 = every CPU the "
                   "process may use]; the output does not depend on it")
    p.add_argument("-l", "--list", dest="fpath", default="", help="query list file")
    p.add_argument("-L", dest="dr", default="2", help=".shuf file or dim-reduction level [2]")
    p.add_argument("-m", dest="mmry", type=float, default=0,
                   help="max memory GB (bounds sketch groups and search "
                   "query batches; 0 = unbatched)")
    p.add_argument("-n", dest="kmerocrs", type=int, default=1, help="least k-mer occurrence (fastq)")
    p.add_argument("-Q", dest="kmerqlty", type=int, default=0, help="min base quality byte")
    p.add_argument("-r", dest="refpath", default="", help="reference dir")
    p.add_argument("-o", dest="outdir", default=".", help="output dir")
    p.add_argument("-N", dest="num_neigb", type=int, default=0, help="top-N refs [0=all]")
    p.add_argument("-D", dest="mut_dist_max", type=float, default=1.0, help="max distance")
    p.add_argument("-M", dest="metric", type=int, default=0, help="0 Jaccard / 1 Containment")
    p.add_argument("-O", dest="outfields", type=int, default=2, help="0 dist / 1 +qv / 2 +CI / 3 full 4-metric table")
    p.add_argument("--correction", type=int, default=0, help="shared-count correction")
    p.add_argument("-A", dest="abundance", action="store_true", help="abundance (koc) mode")
    p.add_argument("-u", dest="dedup", action="store_true", help="drop repeated ref k-mers")
    p.add_argument("--keepcofile", action="store_true",
                   help="also write per-genome <i>.co.<c> intermediates")
    p.add_argument("-P", dest="pipecmd", default="", help="pipe command")
    p.add_argument("--keepskf", action="store_true", help="keep shared-kmer matrix")
    p.add_argument("-f", dest="skf", default="", help="shared-kmer matrix path")
    p.add_argument("--byread", action="store_true", help="sketch by read")
    p.add_argument("--component-sz", type=int, default=7, help="component space exponent [7]")
    p.add_argument("--device-index", action="store_true",
                   help="run the stage II inversion sort on --device "
                   "(identical artifacts)")
    p.add_argument("--no-dense-index", action="store_true",
                   help="skip the reference-format dense mco.index "
                   "export (2 GiB at CSZ=7); the CSR sidecar is always "
                   "written and is what search loads")
    p.add_argument("--no-compat-order", action="store_true",
                   help="sort-unique dedup; sketch files sorted, distances unchanged")
    p.add_argument("--cpu-count", action="store_true",
                   help="count on the host (numpy oracle), not on --device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help=_DEVICE_HELP)
    p.add_argument("--koc-out", action="store_true",
                   help="append abundance-weighted (koc) rows when the "
                   "query dir has .a files (sketched with -A)")
    p.add_argument("--shard", default="", metavar="I:N",
                   help="sketch only shard I of N (multi-process stage I)")
    p.add_argument("--merge-shards", action="store_true",
                   help="merge a sharded sketch root (from --shard runs) into -o")
    p.add_argument("--mesh", default="", metavar="DPxREF",
                   help="search with the DB sharded over a device mesh, "
                   "e.g. 2x4")
    p.add_argument("--shard-strategy", default="genome",
                   choices=["genome", "code"],
                   help="--mesh DB sharding: 'genome' blocks (column "
                   "outputs, default) or 'code' ranges (summed partials)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler trace (CPU, and CUDA on "
                   "--device cuda) to DIR")
    p.add_argument("remaining", nargs="*", help="query files/dirs")

    p = sub.add_parser("set", help="sketch union/intersection/subtraction")
    p.add_argument("-u", dest="union", action="store_true", help="union")
    p.add_argument("-q", dest="uniq_union", action="store_true", help="uniq union")
    p.add_argument("-s", dest="subtract", default="", help="subtract pan-sketch")
    p.add_argument("-i", dest="intersect", default="", help="intersect pan-sketch")
    p.add_argument("-c", dest="combin_pan", action="store_true", help="combine pans")
    p.add_argument("-g", dest="grouping", default="", help="grouping tsv")
    p.add_argument("-P", dest="print_names", action="store_true", help="print genome names")
    p.add_argument("-p", type=int, default=1, help="threads (accepted)")
    p.add_argument("-o", dest="outdir", default="./", help="output dir")
    p.add_argument("remaining", nargs="*", help="input sketch dir(s)")

    p = sub.add_parser("reverse", help="reverse sketch to k-mer set")
    p.add_argument("-L", dest="shuf", required=True, help=".shuf file")
    p.add_argument("-o", dest="outdir", default=".", help="output dir")
    p.add_argument("-p", type=int, default=1)
    p.add_argument("-b", dest="byreads", action="store_true", help="by reads")
    p.add_argument("--component-sz", type=int, default=7)
    p.add_argument("remaining", nargs="*", help="co dir")

    sub.add_parser("primer", help=argparse.SUPPRESS)  # hidden, like the
    # reference: prints the largest prime below 2^i for i in 8..51
    # (global_wrapper.c:107-109, find_lgst_primer_2pow global_basic.c:364-388)

    p = sub.add_parser("convert", help="composite output -> Krona/QIIME/CAMI"
                       " (ports of src/*.pl, see postproc.py)")
    p.add_argument("mode", choices=[
        "krona", "qiime", "cami",
        # the nine small src/*.pl utilities (postproc.py)
        "extract-taxid", "ac2psid", "csv-subset", "ncbi-ftp",
        "kmer-finder", "species2psid", "species2ncbi", "abv-meta",
        "psid2ncbitax",
    ])
    p.add_argument("-t", dest="tax", default="",
                   help="psid->taxonomy tsv (krona) / psid->ncbi tsv (cami)")
    p.add_argument("-n", dest="nodes", default="",
                   help="taxid,rank,parent,name tsv (cami)")
    p.add_argument("-o", dest="outdir", default="./convert_out")
    p.add_argument("inputs", nargs="+",
                   help="composite report (krona/cami) or Krona tables (qiime)")

    p = sub.add_parser("composite", help="metagenomic composition analysis")
    p.add_argument("-r", dest="refdir", default="", help="reference sketch dir")
    p.add_argument("-q", dest="qrydir", default="", help="query koc sketch dir")
    p.add_argument("-o", dest="outdir", default="./", help="output dir")
    p.add_argument("-p", type=int, default=1, help="threads (accepted, unused)")
    p.add_argument("-b", dest="binvec", action="store_true", help="write .abv vectors")
    p.add_argument("-i", dest="idxbv", action="store_true", help="index .abv vectors")
    p.add_argument("-s", dest="searchbv", type=int, default=-1,
                   help="abv search: 0 cosine / 1 L1 / 2 L2")
    p.add_argument("-d", dest="readabv", action="store_true", help="dump .abv file")
    p.add_argument("--device-search", action="store_true",
                   help="force the dense -s search on --device (auto-selected "
                   "for large matrices; see composite.ABV_DENSE_THRESHOLD)")
    p.add_argument("--host-search", action="store_true",
                   help="force the reference-parity sparse host walk for "
                   "-s even at scale")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help=_DEVICE_HELP)
    p.add_argument("--mesh", default="", metavar="N",
                   help="shard the -q join's reference DB over N devices "
                   "(parallel/sharded_composite.py)")
    p.add_argument("remaining", nargs="*")

    args = parser.parse_args(argv)
    if args.command == "shuffle":
        return _cmd_shuffle(args)
    if args.command == "dist":
        return _cmd_dist(args)
    if args.command == "set":
        from public_kssd_tpu_torch import setops

        return setops.cmd_set(args)
    if args.command == "reverse":
        from public_kssd_tpu_torch import reverse

        return reverse.cmd_reverse(args)
    if args.command == "composite":
        from public_kssd_tpu_torch import composite

        return composite.cmd_composite(args)
    if args.command == "convert":
        from public_kssd_tpu_torch import postproc

        return postproc.cmd_convert(args)
    return _cmd_primer()


def _cmd_primer() -> int:
    from public_kssd_tpu_torch.config import (
        DEFAULT_CTX_SPC_USE_L, LD_FCTR, largest_prime_below_pow2,
    )

    # byte-identical to the reference (find_lgst_primer_2pow's
    # diagnostics, global_basic.c:372, then the dispatch printf,
    # global_wrapper.c:109)
    for w in range(8, 52):
        n = 1 << w
        hshsz = int(float(n) * DEFAULT_CTX_SPC_USE_L / LD_FCTR)
        print(f"w={w}\tspace_sz={n}\thashsize={hshsz}"
              f"\tkmerlimt={int(hshsz * LD_FCTR)}")
        p = largest_prime_below_pow2(w)
        print(f"nearest prime={p}")
        print(p)
    return 0


def _cmd_shuffle(args) -> int:
    from public_kssd_tpu_torch import formats, shufspace
    from public_kssd_tpu_torch.config import MIN_SUBCTX_DIM_SMP_SZ, SketchParams

    if args.k < args.s:
        sys.exit("shuffle: half k-mer length must be >= half substring length")
    if args.s >= 8:
        sys.exit("shuffle: subk should be smaller than 8")
    dim_after = 1 << (4 * (args.s - args.l))
    if dim_after < MIN_SUBCTX_DIM_SMP_SZ:
        print(
            f"warning: dimension after reduction {dim_after} < suggested minimum "
            f"{MIN_SUBCTX_DIM_SMP_SZ}; -s {args.l + 3} is suggested",
            file=sys.stderr,
        )
    params = SketchParams.create(k=args.k, drlevel=args.l, subk=args.s, seed=args.seed)
    if args.random_perm:
        perm = formats.make_shuffled_dim(params, seed=args.seed)
    else:
        # computed space: header id doubles as the Feistel seed, making
        # the .shuf self-describing (shufspace.detect)
        perm = shufspace.make_feistel_dim(params)
    formats.write_shuf(args.o + ".shuf", params, perm)
    print(
        f"kssd_torch shuffle: shuf_id={params.id}, k = {params.k}, "
        f"halfCtxLen = {params.subk}, level= {params.drlevel}"
    )
    return 0


def _is_co_dir(path: str) -> bool:
    from public_kssd_tpu_torch import formats

    return os.path.isfile(os.path.join(path, formats.CO_DSTAT))


def _is_mco_dir(path: str) -> bool:
    from public_kssd_tpu_torch import formats

    return os.path.isfile(os.path.join(path, formats.MCO_DSTAT))


def _load_params(args, device, ready):
    """(params, shuf) where shuf is a ComputedShuf when the .shuf encodes
    a Feistel space (gather-free kernel), else the permutation table. The
    check runs on ``device`` when it is a card (shufspace.detect), after
    ``ready()`` (the card's start) returns."""
    from public_kssd_tpu_torch import formats, shufspace
    from public_kssd_tpu_torch.config import SketchParams

    if os.path.isfile(args.dr):
        params, perm = formats.read_shuf(args.dr, component_sz=args.component_sz)
        ready()
        computed = shufspace.detect(params, perm, device)
        return params, (computed if computed is not None else perm)
    params = SketchParams.create(
        k=args.k, drlevel=int(args.dr), component_sz=args.component_sz
    )
    perm = shufspace.make_feistel_dim(params)
    os.makedirs(args.outdir, exist_ok=True)
    shuf_path = os.path.join(args.outdir, "default.shuf")
    formats.write_shuf(shuf_path, params, perm)
    print(f"generated {shuf_path} (shuf_id={params.id})")
    ready()
    return params, shufspace.ComputedShuf(params.id, params.half_subctx_len)


def _sketch(args, files: list[str], opts, device, ready) -> None:
    """Stage I of ``files`` into ``args.outdir``: the parse pool starts
    first, so that it parses while the ``.shuf`` is read and checked and
    the card starts (``--byread`` reads its files itself); a failure
    before the first genome is taken shuts the pool down."""
    import contextlib

    from public_kssd_tpu_torch import pipeline

    stream = None if opts.byread else pipeline.parsed_streams(files, opts)
    with stream if stream is not None else contextlib.nullcontext():
        params, perm = _load_params(args, device, ready)
        pipeline.run_stage1(files, args.outdir, params, perm, opts,
                            mem_gb=args.mmry, device=device, stream=stream)


def _make_mesh(command: str, spec: str, dp: int, ref: int, device):
    """``parallel.make_mesh`` for a CLI flag; exits with the reason when
    the shape is invalid or too few devices are visible."""
    from public_kssd_tpu_torch import parallel

    try:
        return parallel.make_mesh(dp, ref, device)
    except ValueError as e:
        sys.exit(f"kssd_torch {command} --mesh {spec}: {e}")


def _dist_steps(args) -> tuple[str | None, str | None]:
    """The steps of a ``dist`` command, read from its arguments and
    inputs as the reference's dispatch reads them (command_dist.c:53-192):
    the reference side's ("merge" for --merge-shards, "shard" for
    --shard, "sketch" for -r raw sequences: stage I and II into -o,
    "index" for -r a sketch dir: stage II in place, else None) and the
    query side's ("search" with -r, "index" for one sketch dir, "combine"
    for several, "sketch" for raw sequences, else None)."""
    if args.merge_shards:
        return "merge", None
    if args.shard:
        return "shard", None
    ref = qry = None
    if args.refpath:
        if not (_is_co_dir(args.refpath) or _is_mco_dir(args.refpath)):
            ref = "sketch"
        elif not _is_mco_dir(args.refpath):
            ref = "index"
    if args.remaining or args.fpath:
        first = args.remaining[0] if args.remaining else ""
        if args.refpath:
            qry = "search"
        elif first and _is_co_dir(first) and not args.pipecmd:
            qry = "index" if len(args.remaining) == 1 else "combine"
        else:
            qry = "sketch"
    return ref, qry


def _card_work(args, steps) -> tuple[str, ...] | None:
    """What the ``dist`` ``steps`` run on the card (``start.CardStart``'s
    work names);
    None when they run nothing there: ``--device cpu``, merging shards,
    combining sketch dirs, stage II without ``--device-index``, a search
    with ``--cpu-count`` or ``-f``."""
    if args.device != "cuda":
        return None
    work, card = [], False
    for step in steps:
        if step in ("shard", "sketch"):
            work.append("sketch")
            card = True
        elif step == "index":
            card = card or args.device_index
        elif step == "search" and not (args.cpu_count or args.skf):
            # the mesh loads its index on the host
            work += ["count"] if args.mesh else ["count", "index"]
            card = True
    return tuple(work) if card else None


def _cmd_dist(args) -> int:
    if args.p < 0:
        sys.exit(f"dist -p: threads must be >= 0 (0 = every usable CPU), got {args.p}")
    steps = _dist_steps(args)
    work = _card_work(args, steps)
    card = None
    if work is not None:
        from public_kssd_tpu_torch import start

        card = start.CardStart(args.device, work)
    try:
        from public_kssd_tpu_torch import resolve_device
        from public_kssd_tpu_torch.utils import profile_trace

        device = resolve_device(args.device)
        if args.profile and card is not None:
            card.join()  # the profiler starts on a started card
        with profile_trace(args.profile or None, device):
            return _cmd_dist_inner(args, device, steps,
                                   card.join if card else _no_wait)
    finally:
        if card is not None:
            card.close()


def _no_wait() -> None:
    """``ready`` of a command that starts no card."""


def _cmd_dist_inner(args, device, steps, ready) -> int:
    """``dist``'s ``steps`` (``_dist_steps``); ``ready()`` returns once
    the card has started (``start.CardStart.join``) and is called before
    each step's first device call."""
    from public_kssd_tpu_torch import index, infiles, pipeline, search
    from public_kssd_tpu_torch.ops import stats as stats_ops

    index_device = device if args.device_index else None
    opts = pipeline.SketchOptions(
        abundance=args.abundance,
        min_occurrence=args.kmerocrs,
        min_qual=args.kmerqlty,
        uniq=args.dedup,
        byread=args.byread,
        pipecmd=args.pipecmd or None,
        compat_order=not args.no_compat_order,
        keepcofile=args.keepcofile,
    )
    out_opts = stats_ops.OutputOptions(
        metric=stats_ops.Metric(args.metric),
        fields=stats_ops.Fields(args.outfields),
        correction=bool(args.correction),
        max_dist=args.mut_dist_max,
        top_n=args.num_neigb,
    )

    ref_step, qry_step = steps
    if ref_step == "merge":
        from public_kssd_tpu_torch.parallel import distributed

        distributed.merge_shards(args.remaining[0], args.outdir)
        return 0
    if ref_step == "shard":
        from public_kssd_tpu_torch.parallel import distributed

        try:
            shard_id, n_shards = (int(x) for x in args.shard.split(":"))
        except ValueError:
            sys.exit(f"dist --shard: expected I:N, got {args.shard!r}")
        if not 0 <= shard_id < n_shards:
            sys.exit(f"dist --shard {args.shard}: need 0 <= I < N")
        if args.fpath:
            files = infiles.organize_infile_list(args.fpath)
        else:
            files = infiles.organize_infiles(args.remaining, fmt_ck=not args.pipecmd)
        params, perm = _load_params(args, device, ready)
        distributed.sketch_shard(
            files, args.outdir, params, perm, opts, shard_id, n_shards,
            device=device,
        )
        return 0

    # --- reference side (command_dist.c:60-107) ---
    if ref_step == "sketch":
        # raw sequences: sketch + index into outdir
        files = infiles.organize_infiles([args.refpath])
        if not files:
            sys.exit(f"no valid input files in {args.refpath}")
        ref_opts = pipeline.SketchOptions(**{
            **opts.__dict__, "abundance": False  # command_dist.c:94
        })
        _sketch(args, files, ref_opts, device, ready)
        index.run_stage2(args.outdir, args.outdir, args.component_sz,
                         dense=not args.no_dense_index,
                         device=index_device)
        args.refpath = args.outdir
    elif ref_step == "index":
        ready()
        index.run_stage2(args.refpath, args.refpath, args.component_sz,
                         dense=not args.no_dense_index,
                         device=index_device)

    # --- query side (command_dist.c:108-190) ---
    if qry_step is not None:
        qry = args.remaining[0] if args.remaining else ""

        if qry_step == "search":
            if not _is_mco_dir(args.refpath):
                sys.exit("need the ref db dir (with index) for -r search mode")
            if not (qry and _is_co_dir(qry) and not args.pipecmd):
                sys.exit(
                    "search mode needs a sketched query dir: run "
                    "'kssd_torch dist -L <shuf> -o <qdir> <seqs>' first"
                )
            mesh = None
            if args.mesh:
                try:
                    dp, ref = (int(x) for x in args.mesh.lower().split("x"))
                except ValueError:
                    sys.exit(f"dist --mesh: expected DPxREF (e.g. 2x4), got "
                             f"{args.mesh!r}")
                ready()
                mesh = _make_mesh("dist", args.mesh, dp, ref, device)
            search.search(
                args.refpath,
                qry,
                args.outdir,
                out_opts,
                device=None if args.cpu_count else device,
                keep_shared_kmer=args.keepskf,
                shared_kmer_path=args.skf or None,
                mesh=mesh,
                component_sz=args.component_sz,
                mem_gb=args.mmry,
                koc=args.koc_out,
                shard_strategy=args.shard_strategy,
                threads=args.p,
                ready=ready,
            )
            return 0
        if qry_step == "index":
            ready()
            index.run_stage2(qry, args.outdir, args.component_sz,
                             dense=not args.no_dense_index,
                             device=index_device)
            return 0
        if qry_step == "combine":
            from public_kssd_tpu_torch import combine

            combine.combine_queries(args.remaining, args.outdir)
            return 0
        # raw sequences -> sketch into outdir
        if args.fpath:
            files = infiles.organize_infile_list(args.fpath)
        else:
            files = infiles.organize_infiles(args.remaining, fmt_ck=not args.pipecmd)
        if not files:
            sys.exit("please specify valid query sequences")
        _sketch(args, files, opts, device, ready)
        return 0
    if args.refpath and _is_mco_dir(args.refpath):
        print(
            f"{args.refpath} is already indexed and no query was given; "
            "nothing to do (pass a sketched query dir to search)",
            file=sys.stderr,
        )
    return 0


def close_out(rc: int) -> int:
    """End this process with exit code ``rc``, which a command has just
    returned: shut logging down, flush stdout and stderr, then
    ``os._exit(rc)``. Every output file is closed by then (the stages
    write through ``with``; stage I's parse pool and the search's print
    pool are shut down inside ``main``).

    Returns ``rc`` instead, and leaves the end to the interpreter's exit
    as before, where that exit does more than free the process:
    * ``rc`` is not an int (``sys.exit`` prints it);
    * a torch.distributed group is up (its teardown is an ``atexit``
      handler, ``parallel/distributed.py``);
    * a thread that is not a daemon is still alive, which the
      interpreter would wait for; the index loader's readers
      (``index._readers``, kept for the process) do not count: they are
      idle once a load has returned, and they only read;
    * the flush fails (stdout into a closed pipe: the interpreter
      reports it and ends with code 120)."""
    if not isinstance(rc, int):
        return rc
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return rc
    me = threading.current_thread()
    if any(t is not me and not t.daemon and not t.name.startswith("kssd-index-read")
           for t in threading.enumerate()):
        return rc
    if "logging" in sys.modules:
        sys.modules["logging"].shutdown()
    try:
        for stream in (sys.stdout, sys.stderr):
            if stream is not None:  # None where the descriptor was closed
                stream.flush()
    except (OSError, ValueError):
        return rc
    os._exit(rc)


def entry(argv: list[str] | None = None) -> int:
    """The ``kssd_torch`` command: ``main``, then ``close_out`` of the
    code it returns. Whatever ``main`` raises passes through unchanged."""
    return close_out(main(argv))


if __name__ == "__main__":
    sys.exit(entry())
