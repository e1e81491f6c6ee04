"""Entry points of the port: the serve launcher (`python -m
repro_torch.launch.serve`) and the fleet's worker processes
(`launch/workers.py`). Importing this package imports nothing else."""
