"""The yardstick of the video_spike_torch benchmark: cell discovery, the
step clock, trace reduction, FLOP and byte counts, the table of peaks and
the comparison that decides ``correct``. Nothing here imports the program
at module level; the runners import it when they run."""
