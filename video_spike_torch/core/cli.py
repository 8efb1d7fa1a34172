"""Shared CLI argument surface for every entry point.

Flag-for-flag parity with the reference parser
(``reference:src/utils/utils.py:36-47``): ``--model_config
--train_config --seed --log_dir --eid --input_mod --model --save_plot``, plus
framework-level extras (``--data_dir``, ``--num_epochs`` overrides for quick
runs) which default to the config values when omitted. The port adds
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse


def get_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="IBL Spike Video (PyTorch/CUDA port)")
    parser.add_argument("--model_config", type=str,
                        default="configs/model/model_config.yaml",
                        help="Model config file")
    parser.add_argument("--train_config", type=str,
                        default="configs/train/train_config.yaml",
                        help="Train config file")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--log_dir", type=str, default="logs", help="Log directory")
    parser.add_argument("--eid", type=str,
                        default="d57df551-6dcb-4242-9c72-b806cff5613a",
                        help="IBL session id")
    parser.add_argument("--input_mod", type=str, default="whisker-motion-energy",
                        help="Input modality")
    parser.add_argument("--model", type=str, default="cm", help="Model name")
    parser.add_argument("--save_plot", action="store_true", help="Save plot")
    # framework extras (None -> take from config)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Override config dirs.data_dir")
    parser.add_argument("--num_epochs", type=int, default=None,
                        help="Override training.num_epochs")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="Override SSL max steps")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from model_last (params+optimizer+epoch)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Override training.train_batch_size")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no card is "
                             "present, 'cpu' must be asked for")
    return parser.parse_args(argv)
