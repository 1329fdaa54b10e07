"""ide3d_tpu_torch — the PyTorch/CUDA port of ide3d_tpu for NVIDIA Hopper (H100).

The JAX package `ide3d_tpu` stays the reference; this package mirrors its
module layout and names so that each module's counterpart is easy to find:

  ops/     bias_act, upfirdn2d, conv2d_resample, modulated_conv2d, tri-plane
           sampling, and ray_march (the hand-written CUDA kernel K1 + its plain
           PyTorch version)
  render/  camera, integration (compositing + sample_pdf), TriplaneRenderer
  models/  layers, mapping, blocks, generator (Ide3dGenerator), encoder
           (HybridEncoder, MultiViewHybridEncoder), discriminator, arcface
           (IR-SE50), bisenet, e4e, clip (CLIP ViT-B/32 and its tokenizer),
           mtcnn (P-/R-/O-Net and the cascade), face_recon (Deep3DFaceRecon's
           ResNet-50), stylegan2 (the TF1-era StyleGAN2 generator)
  editing/ latent_editor (GANSpace, InterFaceGAN, the StyleCLIP LevelsMapper)
  train/   gan (the GAN train step, lazy R1), augment (ADA), pti (the w+
           projector and pivotal tuning), encoder (the hybrid-encoder step),
           losses, styleclip (the mapper step, latent optimization), nada
  parallel/ stats (StatsAccumulator)
  data/    dataset (image + seg + camera label folders, infinite_loader),
           preprocess (the FFHQ pose math and the POS-aligned crop)
  io/      from_jax: the JAX parameter tree -> this package's modules;
           checkpoint: torch-native train-state snapshots; torch_import:
           reference .pkl checkpoints -> this package's G, D and E, .pt /
           .pth state dicts and e4e files read without running their
           pickles, BiSeNet weights; tf_legacy: TF1-era (G, D, Gs) pickles
  utils/   seg (the 19-class palette), marching (marching tetrahedra)
  apps/    gen_images, painter, web_ui, train_gan, gen_videos,
           extract_shapes, render_mesh, avg_spectra, calc_metrics, run_pti,
           latent_creator, infer_hybrid_encoder, train_hybrid_encoder,
           finetune_hybrid_encoder, calc_losses_on_images, styleclip_edit,
           train_styleclip_mapper, train_nada, edit_comparison,
           experiment_runner, viz_renderer, infer_face_animation,
           converter_log_to_video, preprocess_in_the_wild, dataset_tool
  csrc/    CUDA C++ sources, compiled with nvcc at first use (see _build.py)

Inside the conv stacks activations are NCHW and conv weights OIHW; the public
functions of the renderer and generator keep the JAX layouts (rays [B,R,S,C],
coords [B,N,3], planes [B,H,W,3C], images NHWC). This package imports torch
and never jax.
"""

__version__ = "0.1.0"
