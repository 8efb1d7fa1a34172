"""Figures (counterpart of ``video_spike_tpu/viz``); only what the ported
entry points call. matplotlib is imported inside each function: the card's
machine has none, and nothing there asks for a figure."""
