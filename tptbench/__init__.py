"""The benchmark of tpt_torch, the PyTorch and CUDA port of tpt: one
command (`python -m tptbench.run`) that runs a cell of BENCHMARK.json on
the card and prints one JSON result line. See README.md."""
