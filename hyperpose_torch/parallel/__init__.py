"""Multi-process execution of the PyTorch port on `torch.distributed`: the
process group and its ("dp", "sp") mesh (`mesh.py`), the Sync_sgd gradient
exchange (`train_step.py`), the Sync_avg / Pair_avg weight exchange
(`sync_modes.py`), the sharded stream engine (`stream_shard.py`), and the
row split with its halo exchanges that GSPMD does in JAX (`spatial.py`); a
port of `hyperpose_tpu/parallel/`."""
