"""Command-line interface: fit / scan / aggregate / gxg / merge / vcf2gds /
info, the subcommands and flags of ``python -m saigegds_tpu``, plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the host):

    python -m saigegds_tpu_torch fit --formula "y ~ x1 + x2" \\
        --pheno pheno.tsv --gds grm.gds --out model.npz [--dense] [--stream]
    python -m saigegds_tpu_torch fit --formula "y ~ x1 + x2" \\
        --pheno-cols y1,y2 --pheno pheno.tsv --gds grm.gds \\
        --out model_{}.npz                                  # PheWAS fit
    python -m saigegds_tpu_torch scan --gds geno.gds --model model.npz \\
        --out assoc.gds [--mac 10] [--shard i/n]
    python -m saigegds_tpu_torch scan --gds geno.gds --model m0.npz \\
        --model m1.npz --out assoc_{}.gds          # one pass, two models
    python -m saigegds_tpu_torch burden|acat-v|acat-o --gds ... \\
        --model ... --win-size 10000 --win-shift 5000 --out out.gds
    python -m saigegds_tpu_torch gxg --formula "y ~ x1 + x2" \\
        --pheno pheno.tsv --gds grm.gds --pairs pairs.tsv --out gxg.gds
    python -m saigegds_tpu_torch merge --prefix out --out merged.gds
    python -m saigegds_tpu_torch info

``--pheno`` is read with the ``csv`` module into a dict of numpy columns:
a column whose cells all parse as numbers is numeric (NA and empty cells
are NaN), any other holds strings, which the formula's design matrix
turns into factor levels.  ``--shard``, ``--chr``, ``--pos-range`` and
``--unit-shard`` select variant (or unit) ranges, not devices.
"""

import argparse
import math
import sys

import numpy as np


def _read_pheno(path: str) -> dict:
    from saigegds_tpu_torch.utils.stats import read_table
    low = path.lower()
    return read_table(path, "," if low.endswith((".csv", ".csv.gz"))
                      else "\t")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="saigegds_tpu_torch")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", parents=[common],
                       help="fit the null GLMM (seqFitNullGLMM_SPA)")
    p.add_argument("--formula", required=True)
    p.add_argument("--pheno", required=True)
    p.add_argument("--gds", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--trait", default="binary",
                   choices=["binary", "quantitative"])
    p.add_argument("--dense", action="store_true",
                   help="dense f64 GRM operator (default: the 2-bit store)")
    p.add_argument("--stream", action="store_true",
                   help="force out-of-core streamed ingestion (default: auto)")
    p.add_argument("--maf", type=float, default=0.005)
    p.add_argument("--missing-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=200)
    p.add_argument("--checkpoint", default="",
                   help="mid-fit checkpoint path prefix (resume on rerun)")
    p.add_argument("--var-ratio-mac-cat", default="",
                   help="comma-separated ascending MAC bin bounds (e.g. "
                        "'10.5,20.5') for MAC-categorized variance ratios "
                        "(opt-in newer-SAIGEgds feature; default pooled)")
    p.add_argument("--pheno-cols", default="",
                   help="comma-separated response columns for a PheWAS-mode "
                        "batched fit over ONE resident GRM (binary or "
                        "quantitative per --trait; --formula supplies the "
                        "shared covariates, its response is replaced; "
                        "--out then needs '{}')")

    for name, hlp in (("scan", "single-variant score+SPA scan"),
                      ("burden", "burden tests over sliding windows"),
                      ("acat-v", "ACAT-V tests"), ("acat-o", "ACAT-O tests")):
        q = sub.add_parser(name, parents=[common], help=hlp)
        q.add_argument("--gds", required=True)
        if name == "scan":
            q.add_argument("--model", required=True, action="append",
                           help="null model (npz/rds); repeat for a "
                                "PheWAS-mode multi-model scan sharing one "
                                "genotype pass (--out then needs '{}')")
        else:
            q.add_argument("--model", required=True)
        q.add_argument("--out", required=True)
        q.add_argument("--res-compress", default="LZMA",
                       choices=["LZMA", "LZMA_RA", "ZIP", "ZIP_RA", "none"],
                       help="result-file compression (gds pipes; rds/rda "
                            "stream, reference res.compress)")
        if name == "scan":
            q.add_argument("--mac", type=float, default=10.0)
            q.add_argument("--maf", type=float, default=float("nan"))
            q.add_argument("--shard", default="",
                           help="i/n: scan variant range i of n (0-based)")
            q.add_argument("--model-batch", type=int, default=0,
                           help="max models device-resident per genotype "
                                "pass (0 = all at once)")
            q.add_argument("--chr", default="",
                           help="restrict to chromosome(s), comma-separated")
            q.add_argument("--pos-range", default="",
                           help="restrict to lo:hi base-pair positions")
        else:
            q.add_argument("--win-size", type=int, default=10000)
            q.add_argument("--win-shift", type=int, default=5000)
            q.add_argument("--groups", default="",
                           help="gene-set units instead of sliding windows: "
                                "a JSON {set: [variant ids]} file or a "
                                "2-column TSV (set<TAB>variant id)")
            q.add_argument("--unit-shard", default="",
                           help="'i/n': run unit range i of n (merge the "
                                "tables afterwards)")

    p = sub.add_parser(
        "gxg", parents=[common],
        help="SNP-pair GxG interaction tests (seqGLMM_GxG_spa)")
    p.add_argument("--formula", required=True)
    p.add_argument("--pheno", required=True)
    p.add_argument("--gds", required=True,
                   help="GRM genotype GDS (per-pair null refits)")
    p.add_argument("--pairs", required=True,
                   help="2-column TSV/CSV of variant-id pairs (header "
                        "optional; ids may be integers or strings)")
    p.add_argument("--out", required=True)
    p.add_argument("--assoc-gds", default="",
                   help="GDS holding the tested SNPs (default: --gds)")
    p.add_argument("--use-approx-tau", action="store_true",
                   help="reuse the base fit's tau instead of per-pair refits")
    p.add_argument("--glm-threshold", type=float, default=float("nan"),
                   help="plain-GLM screen p-value: pairs above it skip the "
                        "GLMM refit (reference's glm.threshold)")
    p.add_argument("--pair-batch", type=int, default=0,
                   help=">1: batch that many pairs per solve")
    p.add_argument("--maf", type=float, default=0.005)
    p.add_argument("--missing-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=200)

    p = sub.add_parser("merge", parents=[common],
                       help="row-bind result shards")
    p.add_argument("--prefix", required=True,
                   help="shards are the files <prefix>.part*")
    p.add_argument("--out", required=True)

    p = sub.add_parser("vcf2gds", parents=[common],
                       help="convert a VCF to a genotype GDS")
    p.add_argument("--vcf", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--field", default="GT", choices=["GT", "DS"],
                   help="GT hard calls or DS imputed dosages")
    p.add_argument("--split-multiallelic", action="store_true",
                   help="split multi-allelic rows into biallelic records")

    sub.add_parser("info", parents=[common], help="device/backend report")

    args = ap.parse_args(argv)

    import saigegds_tpu_torch as st
    from saigegds_tpu_torch.config import (AggregateConfig, NullModelConfig,
                                           ScanConfig)

    if args.cmd == "info":
        print(st.device_info())
        return 0

    if args.cmd == "vcf2gds":
        from saigegds_tpu_torch.io.vcf import vcf_to_gds
        n = vcf_to_gds(args.vcf, args.out, field=args.field,
                       split_multiallelic=args.split_multiallelic)
        print(f"wrote {n} variants -> {args.out}")
        return 0

    if args.cmd == "merge":
        from saigegds_tpu_torch.parallel.distributed import merge_shards
        try:
            tab = merge_shards(args.prefix)
        except FileNotFoundError as e:
            sys.exit(str(e))
        st.save_assoc(tab, args.out)
        print(f"merged {len(next(iter(tab.values())))} rows -> {args.out}")
        return 0

    dev = args.device
    if args.cmd == "fit":
        pheno = _read_pheno(args.pheno)
        cfg = NullModelConfig(
            trait_type=args.trait, maf=args.maf,
            missing_rate=args.missing_rate, seed=args.seed,
            checkpoint=args.checkpoint,
            grm_impl="dense" if args.dense else "auto",
            stream_geno=True if args.stream else "auto",
            var_ratio_mac_cat=tuple(
                float(x) for x in args.var_ratio_mac_cat.split(",") if x))
        if args.pheno_cols:
            rhs = args.formula.split("~", 1)[1].strip()
            formulas = [f"{c.strip()} ~ {rhs}"
                        for c in args.pheno_cols.split(",") if c.strip()]
            models = st.fit_null_glmm_multi(formulas, pheno, args.gds, cfg,
                                            model_savefn=args.out,
                                            verbose=True, device=dev)
            for m in models:
                print(m)
        else:
            model = st.fit_null_glmm(args.formula, pheno, args.gds, cfg,
                                     model_savefn=args.out, verbose=True,
                                     device=dev)
            print(model)
        return 0

    if args.cmd == "scan":
        from saigegds_tpu_torch.io.seqarray import SeqData
        kwargs = {}
        seq = SeqData(args.gds)
        if args.shard or args.chr or args.pos_range:
            mask = np.ones(seq.n_variants, bool)
            if args.shard:
                from saigegds_tpu_torch.parallel.distributed import \
                    host_variant_range
                i, n = _parse_shard(args.shard)
                lo, hi = host_variant_range(seq.n_variants, i, n)
                shard = np.zeros(seq.n_variants, bool)
                shard[lo:hi] = True
                mask &= shard
            if args.chr or args.pos_range:
                mask &= seq.variant_selection(
                    chromosome=args.chr.split(",") if args.chr else None,
                    position_range=_parse_pos_range(args.pos_range)
                    if args.pos_range else None)
            kwargs["variant_mask"] = mask
        cfg = ScanConfig(mac=args.mac, maf=args.maf)
        if len(args.model) > 1:
            st.assoc_spa_multi(seq, args.model, cfg, res_savefn=args.out,
                               verbose=True, res_compress=args.res_compress,
                               model_batch=args.model_batch, device=dev,
                               **kwargs)
        else:
            st.assoc_spa(seq, args.model[0], cfg, res_savefn=args.out,
                         verbose=True, res_compress=args.res_compress,
                         device=dev, **kwargs)
        return 0

    if args.cmd == "gxg":
        pheno = _read_pheno(args.pheno)
        pairs = _read_pairs(args.pairs)
        cfg = NullModelConfig(trait_type="binary", maf=args.maf,
                              missing_rate=args.missing_rate, seed=args.seed)
        tab = st.gxg_spa(
            args.formula, pheno, args.gds, pairs,
            gds_assoc=args.assoc_gds or None, config=cfg,
            use_approx_tau=args.use_approx_tau,
            glm_threshold=(False if math.isnan(args.glm_threshold)
                           else args.glm_threshold),
            res_savefn=args.out, verbose=True, pair_batch=args.pair_batch,
            device=dev)
        print(f"gxg: {len(tab['id1'])} pairs -> {args.out}")
        return 0

    # aggregate commands
    from saigegds_tpu_torch.io.seqarray import SeqData
    seq = SeqData(args.gds)
    if args.groups:
        units = st.units_from_groups(seq, _read_groups(args.groups))
    else:
        units = st.sliding_windows(seq, win_size=args.win_size,
                                   win_shift=args.win_shift)
    if args.unit_shard:
        i, n = _parse_shard(args.unit_shard)
        units = st.shard_units(units, i, n)
    fn = {"burden": st.assoc_burden, "acat-v": st.assoc_acat_v,
          "acat-o": st.assoc_acat_o}[args.cmd]
    tab = fn(seq, args.model, units, AggregateConfig(), res_savefn=args.out,
             res_compress=args.res_compress, device=dev)
    print(f"{args.cmd}: {len(next(iter(tab.values())))} units -> "
          f"{args.out}")
    return 0


def _parse_shard(spec: str):
    """'i/n' with 0-based i in [0, n); friendly errors for the rest."""
    try:
        i, n = (int(x) for x in spec.split("/"))
    except ValueError:
        sys.exit(f"--shard expects 'i/n' (0-based), got {spec!r}")
    if not (0 <= i < n):
        sys.exit(f"--shard index {i} outside [0, {n}) — shards are 0-based")
    return i, n


def _parse_pos_range(spec: str):
    lo, _, hi = spec.partition(":")
    try:
        return (int(lo), int(hi))
    except ValueError:
        sys.exit(f"--pos-range expects 'lo:hi' base pairs, got {spec!r}")


def _read_pairs(path: str) -> dict:
    """SNP-pair file -> a dict of its first two columns.  TSV or CSV; a
    header row is detected (a first line whose two leading fields both
    parse as numbers is data, not a header)."""
    import csv
    import gzip

    from saigegds_tpu_torch.utils.stats import _parse_column
    sep = "," if path.endswith((".csv", ".csv.gz")) else "\t"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=sep) if r]

    def _is_num(s):
        try:
            float(s)
            return True
        except ValueError:
            return False
    if not rows or len(rows[0]) < 2:
        sys.exit(f"--pairs expects >=2 columns of variant ids in {path!r}")
    if _is_num(rows[0][0]) and _is_num(rows[0][1]):
        names, body = [0, 1], rows
    else:
        names, body = rows[0][:2], rows[1:]
    return {nm: _parse_column([r[j] for r in body])
            for j, nm in enumerate(names)}


def _read_groups(path: str) -> dict:
    """Gene-set units file: JSON {name: [ids]} or TSV name<TAB>variant id."""
    if path.endswith(".json"):
        import json
        with open(path) as fh:
            return json.load(fh)
    groups: dict = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, vid = line.split("\t")[:2]
            try:
                vid = int(vid)
            except ValueError:
                pass
            groups.setdefault(name, []).append(vid)
    return groups


if __name__ == "__main__":
    sys.exit(main())
