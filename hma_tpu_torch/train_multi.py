"""Training CLI: `python -m hma_tpu_torch.train_multi ...`

The flags of `hma_tpu.train_multi`, plus `--device` (default: the CUDA
card; raises if there is none). Execution is the single-device trainer in
`hma_tpu_torch/train/trainer.py`; flags for what it does not port yet
(the continuous family, a mesh, the native loader, pixel visualisation,
muP, bf16 moments) raise.
"""

from __future__ import annotations

import argparse

from hma_tpu_torch.train.trainer import TrainArgs, run_training


def parse_args(argv=None) -> TrainArgs:
    p = argparse.ArgumentParser(description="HMA multi-dataset training (PyTorch port)")
    p.add_argument("--genie_config", type=str, required=True, help="GenieConfig json.")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--train_split", type=str,
                   default="experiments/datasplit/dataset1.yaml")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--model_type", type=str, default="discrete",
                   choices=["discrete", "continuous"])
    p.add_argument("--window_size", type=int, default=12)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--filter_overlaps", action="store_true")
    p.add_argument("--num_episodes_per_dataset", type=int, default=1_000_000)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--per_device_eval_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--num_train_epochs", type=int, default=2)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--max_eval_steps", type=int, default=10)
    p.add_argument("--eval_every_n_steps", type=int, default=1000)
    p.add_argument("--vis_every_n_steps", type=int, default=10_000_000)
    p.add_argument("--lr_scheduler_type", type=str, default="custom_cosine")
    p.add_argument("--num_warmup_steps", type=int, default=500)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_beta_1", type=float, default=0.9)
    p.add_argument("--adam_beta_2", type=float, default=0.999)
    p.add_argument("--adam_eps", type=float, default=1e-8)
    p.add_argument("--checkpointing_steps", type=str, default="1000")
    p.add_argument("--keep_checkpoints", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--overfit_first_batch", action="store_true")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--mu_transfer", action="store_true")
    p.add_argument("--action_network", type=str, default=None)
    p.add_argument("--run_name", type=str, default="")
    p.add_argument("--report_to", type=str, default="jsonl")
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--no_grad_checkpointing", dest="grad_checkpointing",
                   action="store_false")
    p.add_argument("--save_second_epoch", action="store_true")
    p.add_argument("--use_native_loader", action="store_true")
    p.add_argument("--tokenizer_checkpoint", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--adam_moment_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--sliced_grads", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return TrainArgs(**vars(p.parse_args(argv)))


def main(argv=None):
    metrics = run_training(parse_args(argv))
    print("final:", metrics)


if __name__ == "__main__":
    main()
