"""Command-line interface.

Flag surface and defaults match the reference (argument_parser.hpp:29-174)
and shark_tpu's CLI: -r/-1 required; -2 enables paired mode; -o/-p default
to sharked_sample.1/.2; -k default 17 (max 31); -c default 0.6; -b Bloom
size in GB units of 2**33 bits; -q minimum base quality; -s single-
association mode; -t threads; -v verbose. Associations go to stdout as
"read_id gene_id" lines.

Device extras: --batch-size, --max-read-len, --backend, --save-index/
--load-index, --ssv, --resume and --stats-json. The flags of paths not in
the PyTorch port yet (--devices > 1, --sharded-bf, --num-hosts > 1,
--backend native, --profile-dir, --probe xl|classic) are accepted by the
parser and then refused with a "not in the port yet" error.
"""

from __future__ import annotations

import argparse
import sys

from shark_tpu_torch.config import SharkConfig, not_ported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shark-tpu-torch",
        description=(
            "Mapping-free gene separation of RNA-Seq reads on a CUDA GPU: "
            "indexes reference gene sequences as a k-mer Bloom filter and "
            "reports, for each sample read, the gene(s) it most plausibly "
            "comes from."
        ),
    )
    p.add_argument("-r", "--reference", required=True,
                   help="reference sequences in FASTA format (can be gzipped)")
    p.add_argument("-1", "--sample1", required=True,
                   help="sample in FASTQ (can be gzipped)")
    p.add_argument("-2", "--sample2", default="",
                   help="second sample in FASTQ (optional, can be gzipped)")
    p.add_argument("-o", "--out1", default="",
                   help="first output sample in FASTQ (default: sharked_sample.1)")
    p.add_argument("-p", "--out2", default="",
                   help="second output sample in FASTQ (default: sharked_sample.2)")
    p.add_argument("-k", "--kmer-size", type=int, default=17,
                   help="size of the kmers to index (default:17, max:31)")
    p.add_argument("-c", "--confidence", type=float, default=0.6,
                   help="confidence for associating a read to a gene (default:0.6)")
    p.add_argument("-b", "--bf-size", type=int, default=1,
                   help="bloom filter size in GB (default:1)")
    p.add_argument("-q", "--min-base-quality", type=int, default=0,
                   help="minimum base quality (Phred+33; default:0 = no filtering)")
    p.add_argument("-s", "--single", action="store_true",
                   help="report an association only if a single gene is found")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host worker threads (reference flag): N-1 extra "
                        "native encode threads")
    p.add_argument("-v", "--verbose", action="store_true", help="verbose mode")
    # device extras (no reference analogue)
    p.add_argument("--batch-size", type=int, default=8192,
                   help="reads per device batch (default: 8192)")
    p.add_argument("--max-read-len", type=int, default=0,
                   help="fixed padded (fused) read length; 0 = auto (a "
                        "parse-only pre-scan picks the native engine's "
                        "geometry; set explicitly to skip the scan)")
    p.add_argument("--backend", default="",
                   help="'' (default) runs on the CUDA card and fails "
                        "without one; 'cpu' runs the kernels' plain "
                        "PyTorch versions on the host")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel device count (only 1 is ported)")
    p.add_argument("--sharded-bf", action="store_true",
                   help="shard the Bloom filter (not ported)")
    p.add_argument("--save-index", default="",
                   help="serialize the built index to this .npz path")
    p.add_argument("--load-index", default="",
                   help="load a prebuilt index instead of building from FASTA")
    p.add_argument("--ssv", default="", dest="ssv_path",
                   help="write associations to this file instead of stdout")
    p.add_argument("--no-native", action="store_true",
                   help="disable the native C++ host I/O engine")
    p.add_argument("--probe", default="auto",
                   choices=("auto", "hashed", "xl", "classic"),
                   help="probe-path selection: auto (default) and hashed "
                        "use the one-gather hashed table; xl and classic "
                        "are not ported")
    p.add_argument("--profile-dir", default="",
                   help="profiler trace directory (not ported)")
    p.add_argument("--compile-cache", default="~/.cache/shark_tpu/xla",
                   metavar="DIR",
                   help="accepted for parity with shark-tpu; no effect")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint per batch to <ssv>.progress and resume "
                        "an interrupted run from the last checkpoint "
                        "(requires --ssv, --max-read-len, plain outputs)")
    p.add_argument("--stats-json", default="",
                   help="write machine-readable run statistics (reads, "
                        "associations, phase seconds, reads/s) to this "
                        "path as one JSON object")
    # multi-host launch flags of shark_tpu (not ported)
    p.add_argument("--coordinator", default="",
                   help="multi-host coordinator address (not ported)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="total hosts in a multi-host run (only 1 is ported)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's index in [0, num-hosts)")
    return p


def config_from_args(args: argparse.Namespace) -> SharkConfig:
    return SharkConfig(
        fasta_path=args.reference,
        sample1_path=args.sample1,
        sample2_path=args.sample2,
        out1_path=args.out1,
        out2_path=args.out2,
        k=args.kmer_size,
        c=args.confidence,
        bf_gb=args.bf_size,
        min_quality=args.min_base_quality,
        single=args.single,
        verbose=args.verbose,
        threads=args.threads,
        batch_size=args.batch_size,
        max_read_len=args.max_read_len,
        backend=args.backend,
        devices=args.devices,
        sharded_bf=args.sharded_bf,
        save_index=args.save_index,
        load_index=args.load_index,
        ssv_path=args.ssv_path,
        use_native=not args.no_native,
        probe=args.probe,
        profile_dir=args.profile_dir,
        compile_cache=args.compile_cache,
        resume=args.resume,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    try:
        cfg.validate()
        if not (0 <= args.host_id < args.num_hosts):
            raise ValueError("--host-id must be in [0, num-hosts)")
        if args.num_hosts > 1:
            raise not_ported("--num-hosts > 1", "multi-host")
    except (ValueError, NotImplementedError) as e:
        print(f"shark-tpu-torch: {e}\naborting...", file=sys.stderr)
        return 1
    from shark_tpu_torch.pipeline import run_pipeline

    stats = run_pipeline(cfg)
    if args.stats_json:
        import json

        stats = dict(stats)
        if stats.get("classify_s"):
            # classify_s covers only this invocation; a resumed run's
            # n_reads includes the prior invocations' prefix
            done_now = stats["n_reads"] - stats.get("resumed_reads", 0)
            stats["reads_per_sec"] = round(
                done_now / stats["classify_s"], 1
            )
        with open(args.stats_json, "w") as f:
            json.dump(stats, f)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
