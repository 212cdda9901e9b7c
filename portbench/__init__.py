"""The PyTorch/CUDA port's benchmark (see ``run.py``)."""
