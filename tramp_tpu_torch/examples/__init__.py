"""The examples gallery on tramp_tpu_torch: the scripts of the JAX
package's ``examples/`` with the same groups and file names.

Each script runs as ``python -m tramp_tpu_torch.examples.<group>.<name>
[--big] [--device cpu] [--out DIR]``, on the first CUDA device unless
``--device`` names another; ``main(argv=None)`` takes the same arguments as
a list and returns what the script computed. ``--big`` (where the JAX
script has it) is the reference protocol's size. CSV and npz files go to
``--out``, by default ``build/examples_torch/<group>/`` in the checkout.

- ``glm``: compressed sensing and the perceptron (EP against SE over
  alpha), phase retrieval, the door's critical lines, two-layer phase
  retrieval, compressed-sensing universality and the fast paths
  (``dispatch_solver`` and the gated bf16 solve);
- ``figures``: the sparse-regression and sparse-phase-retrieval figure
  protocols (EP seeds as lanes of one batched solve, SE and Bayes-optimal
  grids as one batched SE solve), the (alpha, rho) phase diagram and the
  SE grid's scaling over a device mesh, and EP's wall time;
- ``sparse``: sparse-gradient regression, the sparse FFT, image
  deconvolution and denoising;
- ``low_rank``: the matrix-factorization noise sweep against its K x K SE;
- ``vae_prior``: inpainting with a VAE decoder as prior.

The package's ``__init__`` imports none of them."""
