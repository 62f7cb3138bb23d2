"""PyTorch modules: classifier f, Psi, Theta, the adapted generator, the bundle."""
