"""Post-processing converters: kssd composite output -> Krona / QIIME /
CAMI taxonomic-profile formats, plus the taxonomy/ftp helper scripts.

Faithful Python ports of ALL TWELVE reference Perl scripts under src/
(SURVEY.md C16); each is golden-tested against the original script run
by the system perl (tests/test_postproc.py). The three most-used:

  krona  <- src/kssdcomposite2gtdb_tax_kronafmt.pl   (73 LoC)
  qiime  <- src/merge_krona_otu_tabs2qiime.pl        (73 LoC)
  cami   <- src/kssdcomposite2taxonomy_profilefmt.pl (136 LoC)

Perl quirks (non-obvious but reproduced on purpose): `split /\\t+/`
collapses consecutive tabs, numeric psid tie-break in the Krona sort,
the CAMI converter OVERWRITES (not sums) duplicate psid->same-species
abundances while ancestors accumulate per psid (with a many-to-one
psid mapping the Perl is nondeterministic — randomized hash order picks
the surviving psid; the real GTDB mapping is 1:1, and this port uses
composite-file order), and a node whose parent
is the root gets an empty TAXPATH.
"""

from __future__ import annotations

import os
import re

# thresholds (kssdcomposite2gtdb_tax_kronafmt.pl:7-12)
KRONA_MEDIAN_THR = 1.0
KRONA_AVG_THR = 3.0
KRONA_SHKM_THR = 8.0
KRONA_LOW_AVG_THR = 2.0
KRONA_SMALL_VAL = 0.1

# thresholds (kssdcomposite2taxonomy_profilefmt.pl:7-12)
CAMI_MEDIAN_THR = 1.0
CAMI_AVG_THR = 3.0
CAMI_SHKM_THR = 7.0
CAMI_LOW_AVG_THR = 2.0
CAMI_SMALL_VAL = 0.001

_CMP_FMT = (".gz",)
_SEQ_FMT = (".fq", ".fastq", ".fa", ".fna", ".fas", ".fasta")

RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus",
         "species")


def _basename_strip(path: str) -> str:
    """File::Basename::basename with the .gz then seq-suffix strips
    (kssdcomposite2gtdb_tax_kronafmt.pl:30-37)."""
    b = os.path.basename(path)
    for s in _CMP_FMT:
        if b.endswith(s):
            b = b[: -len(s)]
            break
    for s in _SEQ_FMT:
        if b.endswith(s):
            b = b[: -len(s)]
            break
    return b


def composite_to_krona(composite_tsv: str, psid2tax_tsv: str, outdir: str) -> str:
    """kssdcomposite2gtdb_tax_kronafmt.pl: one sample's composite report
    -> Krona-format <outdir>/<sample>. Returns the output path."""
    tax = {}
    with open(psid2tax_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            psid = parts[0].replace(" ", "")
            tax[psid] = "\t".join(parts[1:])

    depth: dict[str, float] = {}
    total = 0.0
    sample = "NULL"
    seen: set[str] = set()
    with open(composite_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            sample_raw, ref, shkm, avg, median = (
                parts[0], parts[1], parts[2], parts[4], parts[5]
            )
            sample = _basename_strip(sample_raw)
            if sample not in seen:
                seen.add(sample)
                if len(seen) > 1:
                    raise SystemExit(
                        "Error: Client mode only accept 1 sample one time"
                    )
            psid = ref.split("_")[0]
            shkm, avg, median = float(shkm), float(avg), float(median)
            if shkm <= KRONA_SHKM_THR:
                continue
            if avg > KRONA_AVG_THR and median > KRONA_MEDIAN_THR:
                depth[psid] = avg - KRONA_AVG_THR
                total += depth[psid]
            elif avg >= KRONA_LOW_AVG_THR:
                depth[psid] = max(avg - KRONA_AVG_THR, KRONA_SMALL_VAL)
                total += depth[psid]

    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, sample)
    with open(out, "w") as f:
        for psid in sorted(depth, key=lambda p: (-depth[p], float(p))):
            f.write("%.4f\t%s\n" % (depth[psid] * 100 / total, tax.get(psid, "")))
    return out


def merge_krona_to_qiime(outdir: str, krona_files: list[str]) -> None:
    """merge_krona_otu_tabs2qiime.pl: Krona tables -> otu.tsv +
    taxonomy.tsv + meta.tsv in ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    taxa2otu: dict[str, int] = {}
    otu2taxa: list[str] = []
    abund: dict[tuple[int, int], str] = {}
    for j, path in enumerate(krona_files):
        with open(path) as f:
            for line in f:
                row = line.rstrip("\n").split("\t")
                val, taxa = row[0], ";".join(row[1:])
                if taxa not in taxa2otu:
                    taxa2otu[taxa] = len(otu2taxa)
                    otu2taxa.append(taxa)
                abund[(taxa2otu[taxa], j)] = val
    with open(os.path.join(outdir, "otu.tsv"), "w") as otu, open(
        os.path.join(outdir, "taxonomy.tsv"), "w"
    ) as taxf, open(os.path.join(outdir, "meta.tsv"), "w") as meta:
        meta.write("sample-id\n")
        otu.write("#OTU")
        for path in krona_files:
            otu.write("\t" + path)
            meta.write(path + "\n")
        otu.write("\n")
        for i, taxa in enumerate(otu2taxa):
            otu.write(f"OTU_{i}")
            taxf.write(f"OTU_{i}\t{taxa}\n")
            for j in range(len(krona_files)):
                otu.write("\t" + abund.get((i, j), "0"))
            otu.write("\n")


def composite_to_cami(
    composite_tsv: str, psid2ncbi_tsv: str, nodes_tsv: str
) -> str:
    """kssdcomposite2taxonomy_profilefmt.pl: composite report(s) ->
    CAMI taxonomic-profile text (returned; the Perl prints to stdout)."""
    node2rank, node2pa, node2name = {}, {}, {}
    with open(nodes_tsv) as f:
        for line in f:
            node, rank, pa, name = re.split(r"\t+", line.rstrip("\n"))[:4]
            node2rank[node] = rank
            node2pa[node] = pa
            node2name[node] = name
    psid2ncbi = {}
    with open(psid2ncbi_tsv) as f:
        for line in f:
            psid, ncbi = re.split(r"\t+", line.rstrip("\n"))[:2]
            psid2ncbi[psid] = ncbi

    data: dict[str, dict[str, float]] = {}
    total: dict[str, float] = {}
    order: list[str] = []
    with open(composite_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            sample, ref, shkm, avg, median = (
                parts[0], parts[1], float(parts[2]), float(parts[4]),
                float(parts[5]),
            )
            sample = re.sub(r"[^0-9a-zA-Z_.]", "_", sample)
            psid = ref.split("_")[0]
            if avg > CAMI_AVG_THR and median > CAMI_MEDIAN_THR and shkm > CAMI_SHKM_THR:
                d = avg - CAMI_AVG_THR
            elif avg >= CAMI_LOW_AVG_THR and shkm > CAMI_SHKM_THR:
                d = max(avg - CAMI_AVG_THR, CAMI_SMALL_VAL)
            else:
                continue
            if sample not in data:
                data[sample] = {}
                total[sample] = 0.0
                order.append(sample)
            data[sample][psid] = d
            total[sample] += d

    out = []
    for sample in order:
        rank_cate: dict[str, list[str]] = {r: [] for r in RANKS}
        ab: dict[str, float] = {}
        for psid, d in data[sample].items():
            sp = psid2ncbi[psid]
            if sp not in ab:
                rank_cate.setdefault(node2rank[sp], []).append(sp)
            # Perl overwrites duplicate psid->species abundance (=, not +=)
            ab[sp] = d / total[sample] * 100
            node = node2pa[sp]
            while node != "1":
                if node not in ab:
                    rank_cate.setdefault(node2rank[node], []).append(node)
                    ab[node] = 0.0
                ab[node] += ab[sp]
                node = node2pa[node]
        out.append("# Taxonomic Profiling Output")
        out.append(f"@SampleID:{sample}")
        out.append("@Version:0.9.1")
        out.append("@Ranks:superkingdom|phylum|class|order|family|genus|species")
        out.append("@TaxonomyID:ncbi-taxonomy_2021.07.19")
        out.append("@__program__:kssd2")
        out.append("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE")
        for rank in RANKS:
            for taxid in sorted(rank_cate.get(rank, []), key=lambda t: -ab[t]):
                path, names = [], []
                node = taxid
                # a node whose parent is the root gets an EMPTY path
                # (the Perl loop guards on the parent, :95-101)
                while node2pa[node] != "1":
                    if node2rank[node] in RANKS:
                        path.append(node)
                        names.append(node2name[node])
                    node = node2pa[node]
                out.append(
                    f"{taxid}\t{rank}\t{'|'.join(reversed(path))}"
                    f"\t{'|'.join(reversed(names))}\t{ab[taxid]:.4f}"
                )
    return "\n".join(out) + "\n"


def cmd_convert(args) -> int:
    """CLI dispatch for the ``convert`` subcommand."""
    import sys

    if args.mode == "krona":
        p = composite_to_krona(args.inputs[0], args.tax, args.outdir)
        print(p)
        return 0
    if args.mode == "qiime":
        merge_krona_to_qiime(args.outdir, args.inputs)
        return 0
    if args.mode == "cami":
        sys.stdout.write(composite_to_cami(args.inputs[0], args.tax, args.nodes))
        return 0
    two_arg = {
        "extract-taxid": extract_taxid,
        "ac2psid": ac2pseudotaxid,
        "csv-subset": csv_table_subset,
        "species2psid": gtdbspecies2pseudo_taxid,
        "species2ncbi": gtdbspecies2ncbitaxonomy,
        "abv-meta": abv_match_metadata,
    }
    if args.mode in two_arg:
        sys.stdout.write(two_arg[args.mode](args.inputs[0], args.inputs[1]))
        return 0
    if args.mode == "ncbi-ftp":
        sys.stdout.write(ncbi_accession2ftp(args.inputs[0]))
        return 0
    if args.mode == "kmer-finder":
        for s in kmer_finder(args.inputs[0], int(args.inputs[1])):
            print(s)
        return 0
    if args.mode == "psid2ncbitax":
        sys.stdout.write(gtdbpsid2ncbitax_by_genomesupport(
            args.inputs[0], bool(int(args.inputs[1]))))
        return 0
    return 2


# ---------------------------------------------------------------------------
# the nine remaining src/*.pl utilities (complete C16 coverage); all are
# line-oriented tsv/text transformers returning the exact stdout text the
# Perl produces (golden-tested against the originals)
# ---------------------------------------------------------------------------

_GCA_RE = re.compile(r"(GC[AF]_[0-9.]+)")


def extract_taxid(genomelist: str, g2t_tsv: str) -> str:
    """src/extract_taxid.pl: genome ids -> taxid [+ name] table."""
    h = {}
    with open(g2t_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            gid, taxid = parts[0], parts[1]
            h[gid] = taxid + "\t" + parts[2] if len(parts) > 2 else taxid
    out = []
    with open(genomelist) as f:
        for line in f:
            m = _GCA_RE.search(line.rstrip("\n"))
            gid = m.group(1) if m else ""
            out.append(f"{gid}\t{h.get(gid, '0')}")
    return "\n".join(out) + "\n" if out else ""


def ac2pseudotaxid(accessions: str, ac2tid_tsv: str) -> str:
    """src/ac2pseudotaxid.pl: accessions -> pseudo-taxid [+ name]."""
    h = {}
    with open(ac2tid_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            h[parts[0]] = "\t".join(parts[1:3]) if len(parts) > 2 else parts[1]
    out = []
    with open(accessions) as f:
        for line in f:
            ac = line.rstrip("\n")
            out.append(f"{ac}\t{h.get(ac, '0')}")
    return "\n".join(out) + "\n" if out else ""


def csv_table_subset(all_csv: str, selected_tsv: str) -> str:
    """src/csv_table_subset.pl: keep csv rows whose first comma field is
    listed in the first tab field of ``selected_tsv``."""
    keep = set()
    with open(selected_tsv) as f:
        for line in f:
            keep.add(line.rstrip("\n").split("\t")[0])
    out = []
    with open(all_csv) as f:
        for line in f:
            row = line.rstrip("\n")
            if row.split(",")[0] in keep:
                out.append(row)
    return "\n".join(out) + "\n" if out else ""


def ncbi_accession2ftp(tsv: str) -> str:
    """src/NCBIaccession2ftp_address.pl: accession+ASM id -> rsync URL."""
    out = []
    with open(tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            ac, asm = parts[0], parts[1]
            fac = _GCA_RE.search(ac).group(1)
            asm = re.sub(r"\s", "_", asm)
            gc, num = fac.split("_")[:2]
            m = re.search(r"(\d{3})(\d{3})(\d{3})", num)
            n1, n2, n3 = m.group(1), m.group(2), m.group(3)
            out.append(
                f"rsync://ftp.ncbi.nlm.nih.gov/genomes/all/{gc}/{n1}/{n2}/{n3}"
                f"/{fac}_{asm}/{fac}_{asm}_genomic.fna.gz"
            )
    return "\n".join(out) + "\n" if out else ""


_RC = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def kmer_finder(fasta: str, k: int) -> list[str]:
    """src/kmer_finder.pl: distinct canonical k-mer STRINGS of a fasta
    (case preserved, canonical = lexicographic min of k-mer vs revcomp).
    Returned in first-seen order; the Perl prints hash order, which is
    randomized per process — compare as sets."""
    seen: dict[bytes, None] = {}
    with open(fasta, "rb") as f:
        data = f.read()
    for rec in data.split(b">"):
        if not rec:
            continue
        lines = rec.split(b"\n")
        read = b"".join(lines[1:])
        for i in range(len(read) - k + 1):
            kmer = read[i : i + k]
            rc = kmer.translate(_RC)[::-1]
            seen.setdefault(min(kmer, rc), None)
    return [s.decode() for s in seen]


def gtdbspecies2pseudo_taxid(namelist: str, tid2species_tsv: str) -> str:
    """src/gtdbspecies2pseudo_taxid.pl."""
    h = {}
    with open(tid2species_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            h[parts[1]] = re.sub(r"\s+", "", parts[0])
    out = []
    with open(namelist) as f:
        for line in f:
            name = re.split(r"\t+", line.rstrip("\n"))[0]
            out.append(f"{h.get(name, '0')}\t{name}")
    return "\n".join(out) + "\n" if out else ""


def gtdbspecies2ncbitaxonomy(specieslist: str, gtdb2ncbi_tsv: str) -> str:
    """src/gtdbspecies2ncbitaxonomy.pl: gtdb species -> '|'-joined
    ncbiid_name alternatives."""
    h: dict[str, str] = {}
    with open(gtdb2ncbi_tsv) as f:
        for line in f:
            parts = re.split(r"\t+", line.rstrip("\n"))
            gtdb, ncbi_id, ncbi_tax = parts[0], parts[1], parts[2]
            m = re.search(r";s__(.+)", gtdb)
            if m:
                ent = f"{ncbi_id}_{ncbi_tax}"
                key = m.group(1)
                h[key] = h[key] + "|" + ent if key in h else ent
    out = []
    with open(specieslist) as f:
        for line in f:
            sp = line.rstrip("\n")
            out.append(f"{sp}\t{h.get(sp, '0')}")
    return "\n".join(out) + "\n" if out else ""


def abv_match_metadata(abv_out: str, meta_csv: str) -> str:
    """src/abv_match_metaData.pl: join abv-search output with run
    metadata (bioproject, biosample, organism)."""
    with open(meta_csv) as f:
        head = f.readline().rstrip("\n").split(",")
        c2, c3, c4 = head[1], head[2], head[3]
        h = {}
        for line in f:
            parts = line.rstrip("\n").split(",")
            # perl quirk: list-assignment split keeps trailing EMPTY
            # fields (implicit limit), and `defined ""` is true — so a
            # row like "R2,P2,," IS stored with empty sample/organism
            if len(parts) >= 4:
                h[parts[0]] = "\t".join(parts[1:4])
    out = []
    with open(abv_out) as f:
        for line in f:
            name, measure = line.rstrip("\n").split("\t")[:2]
            if not name.endswith(".abv"):
                out.append(f"{name}\t{measure}\t{c2}\t{c3}\t{c4}")
            else:
                name = name[: -len(".abv")]
                out.append(f"{name}\t{measure}\t" + h.get(name, "NA\tNA\tNA"))
    return "\n".join(out) + "\n" if out else ""


def gtdbpsid2ncbitax_by_genomesupport(tsv: str, all_rows: bool) -> str:
    """src/gtdbpsid2ncbitax_by_genomesupport.pl: pick the NCBI taxonomy
    per GTDB pseudo-taxid by genome-count support (first=best or all)."""
    h: dict[str, dict[str, dict]] = {}
    order: dict[str, list[str]] = {}
    with open(tsv) as f:
        for line in f:
            line = line.rstrip("\n")
            if "GTDB_AC" in line:
                continue
            parts = re.split(r"\t+", line)
            gid, psid, gtname, ncbi_tids, ncbi_taxn = parts[:5]
            if not re.search(r"GC[AF]_\d+", gid):
                continue
            key = f"{psid}_{gtname}"
            tids = ncbi_tids.split("|")
            n = len(tids) - 1
            tid_path = "|".join(tids[:n])
            # perl quirk: $tids[$len-1] with $len=@tids-1 is the
            # SECOND-TO-LAST element, so the grouping id is the genus-
            # level tid and the path still contains it — reproduced
            spcid = tids[n - 1]
            tnames = ncbi_taxn.split("|")
            tname_path = "|".join(tnames[:n])
            e = h.setdefault(key, {}).setdefault(
                spcid, {"gn": 0, "tid_path": "", "tname_path": ""}
            )
            if e["gn"] == 0:
                order.setdefault(key, []).append(spcid)
            e["gn"] += 1
            e["tid_path"] = tid_path
            e["tname_path"] = tname_path
    out = []
    for key in sorted(h):
        ranked = sorted(order[key], key=lambda s: -h[key][s]["gn"])
        picks = ranked if all_rows else ranked[:1]
        for s in picks:
            e = h[key][s]
            out.append(
                f"{key}\t{e['tid_path']}\t{e['tname_path']}\t{e['gn']}"
            )
    return "\n".join(out) + "\n" if out else ""
