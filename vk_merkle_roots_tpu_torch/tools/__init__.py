"""Tools of the PyTorch/CUDA port: the stream generators (rndm, strm), the
proof checker (verify), the randomized differential (fuzz) and the perf
model (perf_model), whose timings need a CUDA card.  The kernels' measured
forms are in PERF.md; where the engine's time goes is the benchmark's traced
run (``portbench/run.py --trace 1``)."""
