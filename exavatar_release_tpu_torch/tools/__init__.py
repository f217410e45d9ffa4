"""Measuring tools of the port: the compositing kernels' stage probes
(``kvariants``) and the per-tile window build (``win_probe``)."""
