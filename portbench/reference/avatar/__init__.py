"""Human Gaussians and their configuration."""
