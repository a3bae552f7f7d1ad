"""The VAE-prior inpainting example."""
