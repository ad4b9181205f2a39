"""One reader a metric: ``<metric>.py`` defines ``read(ctx)``, which gives
the metric's number, or None where the run has nothing to read for it.
``_count`` is the frozen count of useful work and the table of peaks;
``_window`` the arithmetic of the measured window shared by the readers."""
