"""Runnable stages of the port
(`python -m cuda_flashattention_torch.examples.<stage>`)."""
