"""Operations and bytes of the work the benchmark drives, counted from
shapes alone, so that a count reads the same whatever kernel implements the
work. A roofline counts each input byte read once and each output byte
written once; where the work depends on the data it counts what these
inputs need (causal pairs over the valid tokens)."""
