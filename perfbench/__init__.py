"""The benchmark of the PyTorch and CUDA port (`mcos_tpu_torch`): see
`perfbench/harness.py`."""
