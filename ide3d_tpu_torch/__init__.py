"""ide3d_tpu_torch — the PyTorch/CUDA port of ide3d_tpu for NVIDIA Hopper (H100).

The JAX package `ide3d_tpu` stays the reference; this package mirrors its
module layout and names so that each module's counterpart is easy to find:

  ops/     bias_act, upfirdn2d, conv2d_resample, modulated_conv2d, tri-plane
           sampling, and ray_march (the hand-written CUDA kernel K1 + its plain
           PyTorch version)
  render/  camera, integration (compositing + sample_pdf), TriplaneRenderer
  models/  layers, mapping, blocks, generator (Ide3dGenerator), encoder,
           discriminator
  train/   gan (the GAN train step, lazy R1), augment (ADA)
  parallel/ stats (StatsAccumulator)
  data/    dataset (image + seg + camera label folders, infinite_loader)
  io/      from_jax: the JAX parameter tree -> this package's modules;
           checkpoint: torch-native train-state snapshots; torch_import:
           reference .pkl checkpoints -> this package's G, D and E
  utils/   seg (the 19-class palette), marching (marching tetrahedra)
  apps/    gen_images, painter, web_ui, train_gan, gen_videos,
           extract_shapes, render_mesh, avg_spectra
  csrc/    CUDA C++ sources, compiled with nvcc at first use (see _build.py)

Inside the conv stacks activations are NCHW and conv weights OIHW; the public
functions of the renderer and generator keep the JAX layouts (rays [B,R,S,C],
coords [B,N,3], planes [B,H,W,3C], images NHWC). This package imports torch
and never jax.
"""

__version__ = "0.1.0"
