"""CUDA kernels of the LayoutEngine's main path, each with its plain
PyTorch version: ``route_records`` (eval_cuts, locate_leaf),
``fused_ingest`` and ``query_intersect``; ``_build`` compiles them."""
