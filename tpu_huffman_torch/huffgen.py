"""Table-compiler CLI of the PyTorch port (the twin of
``tpu_huffman/huffgen.py``).

Parse a ``.def`` (or TSV) table, validate it (prefix-free, Kraft), and
emit the same data artifacts as the JAX package's CLI:

  python -m tpu_huffman_torch.huffgen table.def --tsv out.tsv    # portable TSV
  python -m tpu_huffman_torch.huffgen table.def --npz out.npz    # compiled LUTs
  python -m tpu_huffman_torch.huffgen table.def --check          # validate only

``--check`` prints ``ok: N codes, lengths a..b, root_bits=r`` and then the
decode LUT that the port's kernels use (``DeviceTable``, built at
min(root_bits, 12)), where the JAX CLI reports its TPU decode planner.
"""

from __future__ import annotations

import argparse
import sys

from .tables import HuffmanTable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_huffman_torch.huffgen",
        description="Compile a Huffman .def/.tsv table into data artifacts.",
    )
    ap.add_argument("input", help="table definition (.def or .tsv)")
    ap.add_argument("--tsv", metavar="OUT", help="emit portable TSV artifact")
    ap.add_argument("--npz", metavar="OUT", help="emit compiled .npz artifact (LUTs included)")
    ap.add_argument("--check", action="store_true", help="validate only")
    ap.add_argument("--name", default=None, help="table name (default: input stem)")
    args = ap.parse_args(argv)

    loader = (
        HuffmanTable.from_tsv_file
        if args.input.endswith(".tsv")
        else HuffmanTable.from_def_file
    )
    try:
        table = loader(args.input, name=args.name)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    n_codes = int((table.lengths > 0).sum())
    if args.check or not (args.tsv or args.npz):
        import torch

        from .ops.encode import DeviceTable

        dt = DeviceTable(table, torch.device("cpu"))
        levels = (
            f"2 levels, {dt.l1.numel()} level-1 entries"
            if table.max_len > dt.root_bits
            else "1 level"
        )
        print(
            f"ok: {n_codes} codes, lengths {table.min_len}..{table.max_len}, "
            f"root_bits={table.root_bits}, lut={dt.root_bits}-bit root, {levels}"
        )
    if args.tsv:
        with open(args.tsv, "w") as f:
            f.write(table.to_tsv())
    if args.npz:
        out = args.npz[:-4] if args.npz.endswith(".npz") else args.npz
        table.save(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
