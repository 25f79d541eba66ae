from klara_tpu_torch.io.checkpoint import load_checkpoint, restore_like, save_checkpoint
from klara_tpu_torch.io.csvio import ChainReader, read_chain, read_chain_csv, write_chain_csv

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "restore_like",
    "write_chain_csv",
    "read_chain_csv",
    "read_chain",
    "ChainReader",
]
