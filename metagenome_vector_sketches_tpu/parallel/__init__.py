"""Multi-chip scaling: mesh construction, sharded pairwise sweeps, and
distributed top-k. This is new architecture with no reference counterpart —
the reference's only 'collective' is the filesystem (SURVEY.md §2.3); here
row-blocks are data-parallel across devices, column blocks travel the
interconnect via all_gather, and top-k results merge with a gather+re-top-k."""
