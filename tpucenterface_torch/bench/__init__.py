"""Measurement tools of the port, each mirroring the JAX package's module of
the same name in `tpucenterface/bench/`:

- `timing`: device time a call by the slope over two loop counts
  (`op_time_ms`, `chain_op_time_ms`, `dep_op_time_ms`) and FIFO-bounded
  images/s (`throughput_images_per_sec`, `fifo_ips`, `fifo_ips_passes`),
  on the device of the caller's tensors;
- `roofline`: whole-program TFLOP/s, `mfu`, TB/s and `hbm_frac` of a per-op
  profile against the H100's datasheet peaks, and per-section floors;
- `op_profile`: a torch.profiler trace of a program reduced to per-op rows
  (category, name, ms, GB, GFLOP, occurrences), and `profile_detect_program`;
- `profile_forward`: per-section times of the module forward;
- `preset_sweep`: serving images/s of each width preset, bf16 and int8_dw;
- `slo_sweep`: request latency percentiles against offered load on a
  `runtime.serving.ServingEngine`.

The five BASELINE configurations are `cli/bench_suite.py`.

The JAX package's two probes have no file here. `probe_int8_conv.py`'s
kernel and reference are `ops/int8_conv.py` (`int8_conv1x1`,
`conv1x1_int8_plain`), and its `run_probe`, which times the kernel against
the library route, is `kernels/sweep_b5.py`. `probe_fused_block.py`'s two
kernels, their references and layout helpers are `ops/int8_block.py`
(`int8_block_s2`, `int8_block_s1`, `pack_int8_block_s1`, the plain
versions), and its `run_probe` and `run_probe_s1` are `kernels/sweep_b6.py`
and `kernels/sweep_b7.py`. The sweeps time each kernel on the card (B5's and
B6's also against a parent tree with `--against`).
"""
