"""Small configurations of the benchmark's cells for the CPU tests: the
same code, a zone of 8 ranks of 64-word pages and a 64-wide xLSTM."""
from __future__ import annotations

ZONE = {"ranks": 8, "block_words": 64,
        "leaves": {"w_fsdp": {"shape": [320, 64], "dtype": "float32",
                              "spec": ["data", "model"]},
                   "w_tp": {"shape": [4, 64], "dtype": "bfloat16",
                            "spec": [None, "model"]},
                   "scale": {"shape": [], "dtype": "float32", "spec": []}},
        "protect": {"mode": "mlpc", "redundancy": 3, "window": 1,
                    "pipeline_depth": 1, "scrub_period": 0,
                    "block_words": 64}}

XLSTM = {"model": {"n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv": 4,
                   "vocab": 512, "block_pattern": ["mlstm"] * 7 + ["slstm"],
                   "param_dtype": "float32", "compute_dtype": "float32"},
         "serve": {"mesh": [4, 2], "batch": 4, "max_len": 2048,
                   "protect": {"mode": "mlpc", "redundancy": 1, "window": 1,
                               "pipeline_depth": 1, "block_words": 64,
                               "scrub_period": 16}}}

CONFIGS = {"zone-g100-r3": ZONE, "xlstm-1.3b": XLSTM}
MIXES = {"patch_zipf128": {"pages": 4}, "decode_b4": {"prompt_len": 6}}
