"""Tools of the port: the compositing kernels' stage probes (``kvariants``),
the per-tile window build (``win_probe``) and the learning check
(``convergence_demo``)."""
