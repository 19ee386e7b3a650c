"""The port's measuring tools (counterparts of the repo root's tools/
throughput_table.py, serve_bench.py and link_benchmark.py), each run as
`python -m mercury_tpu_torch.tools.<tool>` on the CUDA card, or with --cpu
on the plain versions."""
