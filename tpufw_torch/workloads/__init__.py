"""Workload entry points (``python -m tpufw_torch.workloads.train_llama``)."""
