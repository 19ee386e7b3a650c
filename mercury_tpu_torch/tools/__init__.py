"""The port's measuring and qualification tools (counterparts of the repo
root's tools/ of the same names), each run as `python -m
mercury_tpu_torch.tools.<tool>` on the CUDA card, or with --cpu on the
plain versions: throughput_table, serve_bench, link_benchmark, ber_sweep,
ber_campaign, pattern_detect_sweep, fading_ber, audio_stress, roofline and
the host-only log analyzer analyze_link_log."""
