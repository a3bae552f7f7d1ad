"""The sparse and structured examples: sparse gradient, sparse FFT, image
deconvolution and denoising."""
