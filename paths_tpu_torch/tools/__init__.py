"""Measurement tools of the port (counterparts of the JAX repository's
`tools/`):

    python -m paths_tpu_torch.tools.profile_step [--what train|eval]
"""
