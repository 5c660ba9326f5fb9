"""Port of ``x_multi_agent_tpu.place_recognition`` (ground-truth matching)."""
