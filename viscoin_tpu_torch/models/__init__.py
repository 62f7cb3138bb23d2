"""PyTorch modules: classifier f, Psi, Theta, the adapted and original generators,
LPIPS, the bundle."""
