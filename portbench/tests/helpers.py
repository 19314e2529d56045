"""Tiny versions of the cells for the CPU: the same files, with the
widths, depth, traffic and batcher cut so a run takes seconds."""

import copy
import time

from portbench import run as bench_run

TINY = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            vocab_size=64)


def tiny_cell(name: str):
    """(BENCHMARK.json, workload file, configuration file) of ``name``,
    cut to a CPU size."""
    bench, _, wl, cfg = bench_run.load_cell(name)
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg.update(TINY)
    cfg["build"].update(vocab=64, dim=32, heads=4, kv_heads=2, hidden=48,
                        blocks=2)
    if wl["driver"] == "serve_open":
        cfg["build"]["max_seq"] = cfg["max_position_embeddings"] = 96
        wl["traffic"].update(rate_per_s=8, prompt_min=4, prompt_max=40,
                             output_min=4, output_max=40)
        wl["batcher"].update(slots=4, capacity=96, pool_pages=12,
                             page_size=8, decode_chunk=4)
        wl["check"]["tokens"] = 60
    else:
        cfg["build"]["max_seq"] = cfg["max_position_embeddings"] = 64
        wl["traffic"].update(seq_len=64, sequences=2)
    return bench, wl, cfg


def run_tiny(name: str, seed: int = 123456789012, seconds: float = 2.0,
             trace: bool = False):
    bench, wl, cfg = tiny_cell(name)
    metrics = bench_run.cell_metrics(bench, name, trace)
    return bench_run.run_cell(wl, cfg, metrics, seed, seconds, trace,
                              "cpu", 1, [("start", time.perf_counter())])
