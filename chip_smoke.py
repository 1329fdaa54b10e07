"""Smoke run of the PyTorch port on one CUDA card: build, check and time K1,
then drive the frame, the Painter, training, offline generation, the
metric suite, inversion, latent editing, real-photo preprocessing, the
legacy checkpoint import, the optional architectures (the hybrid feature
volume, the SG3 superres, the built-in encoder, fine_steps), the
trainer's last features (path-length regularization through K1's double
backward, wavelet ADA), the trained-weight tools, data parallelism over
every card at the flagship width, the serving artifact, the host loader, and
TRAINING.md's flagship training run B through tools/torch_trained_workflow.py
at cut counts.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device  - needs CUDA; prints the card's name and power limit (nvidia-smi)
  2. build   - nvcc builds ide3d_tpu_torch/csrc/ray_march.cu for sm_90a
  3. kernel  - K1 against its plain version at B=1, R=4096, S=96+96, C=51,
               for each option (softplus, relu, last_back, white_back, density
               noise): fp32 vals (max abs err <= 1e-4), bf16 vals (<= 1e-3);
               saturated density (finite, wsum = 1 +- 1e-4); other shapes with
               ties, staged and streamed (<= 1e-4); then K1 and plain timed at
               B=1 and B=3 (bf16, the frame's shape) from CUDA graphs of many
               calls, beside the byte bound at 3.35 TB/s, and K1 eager, one
               call at a time (the wrapper's host time included)
  4. fp32    - GeneratorConfig(dtype="float32") at batch 1 on the card against
               the same weights on the CPU (plain paths), max abs err <= 3e-5
               x the output's scale
  5. frame   - GeneratorConfig() from init(seed=0), bf16, 96+96 samples: the
               three-yaw batch of gen_images for a few seeds; shapes, finite
               values, the K1 launch count, frame time, peak memory; then one
               frame's captured K1 inputs through kernel and plain
  6. painter - phase 5's G with HybridEncoder(512, 10, 8, bf16).init(seed=1)
               behind PainterWebApp(PainterSession(...)), driven through
               handle() (no socket): meta, seed, two cached views, a new-view
               edit, two strokes, a view of the edited latent, a 12-frame orbit.
               Each request: status 200, 512^2 PNGs, finite images, and its
               exact K1 launches and plane_table calls. A warm-up round
               with the finiteness checks, then timed rounds (wall time per
               route, PNG encoding included); CUDA-event times of a stroke, an
               uncached edit, a cached view and E alone; a cached view against
               G.synthesis (<= 1e-3), a stroke against the uncached edit
               (rec_ws <= 1e-3, uint8 within 1), the fp32 encoder on the card
               against the CPU (<= 3e-5 x scale)
  7. train   - K1's backward against autograd through its plain version at
               B=4, R=4096, S=96+96, C=51, fp32 and bf16 values, sorted and
               unsorted halves, each option: max abs err / max|grad| <= 1e-4
               (fp32), <= 1e-2 (bf16, the gradient rounded once to bf16);
               then timed (CUDA graphs) alone and with the forward, at the
               training render's layout (coarse half sorted, fine unsorted),
               beside the byte bounds, and the plain backward (events). The
               tiny fp32 preset's g-loss, d-loss and R1 (ADA at fixed draws)
               and their G and D gradients, card against CPU (<= 1e-4 x
               max). GeneratorConfig() + Discriminator(img_channels=25), bf16,
               batch 4, a synthetic 512² batch: 6 steps of
               make_gan_train_step at ada_p 0.2 (step 0 with R1) with each
               step's K1 forward and backward launches counted (1 and 1),
               finite stats, R1 on its cadence, G, D and G_ema moved; event
               times, one more (warm) R1 step, peak memory. Then
               apps.train_gan.main --preset full --batch 4 for 2 steps on an
               8-image 512² dataset, and --resume of its snapshot-final, which
               must restore every state dict, the step and ada_p.
  8. offline - GeneratorConfig() and the reference-compat slice G written as
               train_gan snapshots and loaded by load_generator; gen_videos on
               each (16 frames in 2 chunks, bf16): K1 once a chunk, the first
               chunk's K1 inputs through kernel and plain (<= 1e-3), frame 0
               against G.synthesis (within 1 uint8 level); the fp32 ref-compat
               frame card against CPU (<= 3e-5 x scale); extract_shapes at
               256^3 against an fp32 copy's grid (<= 3e-2 x max|sigma|) and that
               copy's first chunk card against CPU (<= 3e-5 x scale);
               render_mesh 128^3 with an 8-frame orbit: K1 once a frame, one
               frame's K1 inputs (fp32, 64+64) through kernel and plain (<= 1e-4)
  9. metrics - the flagship snapshot and 64 labelled 512² images: apps.calc_metrics
               at --batch 8: fid,kid,pr,is (inception, deterministic init) at
               --num-items 256, ppl2_wend (vgg16) at 64, eqt,eqr at 8. Each
               metric finite, its exact K1 launches (one a G pass), total
               time, the generator extraction's images/s, peak memory; K1's
               inputs at B=8 and at B=1 with a pixel offset through kernel and
               plain (<= 1e-3); the calc_metrics runs at cuDNN TF32 on, as
               PyTorch's default; an fp32 copy of G, card against CPU, on the
               first batch: Inception features (<= 1e-5 x max|feature| with
               TF32 off, <= 5e-3 with cuDNN TF32 on), and on a pair of
               deterministic PPL renders VGG16 features (<= 2e-5 x
               max|feature|) and pair distances (<= 2e-2 relative); PPL's
               random renders' distances and the bf16 G's are printed.
               Phase 7's train_gan run also takes --metrics fid
               (inception, 16 items) and must write a finite FID line.
 10. inversion - the flagship bf16 snapshot and 2 targets (512² renders of
               it at a known w + 0.3 N(0, 1), with their seg argmax as masks):
               apps.run_pti.main at 10 projector + 10 PTI steps,
               --lpips-threshold 0, at cuDNN TF32 on (PyTorch's default, as
               a user's process; so is the timed train_hybrid_encoder run),
               with K1's (forward, backward) launches exact per projector
               step (1, 1), PTI step (1, 1) and
               _save_viz (1, 0), the reconstruction MSE falling in both
               loops, each model_<name> reloaded by load_generator within 1
               uint8 level of its _compare.png; one target with --join-view
               --use-locality --video (2 + 4 steps: (4, 3) a PTI step, (61, 0)
               for _save_viz) and one from e4e pivots (a random-init
               E4eEncoder(1024) written in the pSp layout with
               opts.encoder_type); K1 on a projector step's captured inputs
               against plain (bf16 <= 1e-3) and its backward on that step's
               own cotangents against autograd through plain (<= 1e-2 x
               max|grad|); fp32 copies, card (with cuDNN's and with PyTorch's
               own convolutions) against the CPU in fp32 and in float64: a
               projector step's gradients in w+ and the noise, a PTI step's in
               the synthesis parameters (<= 1e-4 x max|grad|, the w+ gradient
               with cuDNN <= 2e-3); apps.train_hybrid_encoder.main
               at --batch 4 for 3 steps on 8 labelled 512² images with masks,
               both branches, random-init --bisenet --vgg-weights
               --lpips-weights --arcface-weights files, (3, 2) K1 launches a
               step, then --resume restoring E, Adam and the step;
               finetune_hybrid_encoder (3 steps), latent_creator (2 x 5 steps),
               calc_losses_on_images l2,lpips,id; ArcFace, BiSeNet and e4e
               (both variants) as fp32 copies, card against CPU (<= 1e-5 x
               max|output|). Event ms per step and peaks; the arithmetic of a
               default run_pti (450 + 350 steps), labelled as arithmetic.
 11. editing - the flagship bf16 snapshot, a random-init full-width CLIP
               ViT-B/32 written by the port's CLIP (OpenAI layout), a
               synthetic BPE vocab and a random-init IR-SE50 file; timed runs
               at cuDNN TF32 on: apps.train_styleclip_mapper.main at batch 2
               with --ir-se50 (6 steps, K1 (2, 1) a step) and without (3 steps,
               (1, 1)), styleclip_edit on its mapper at 3 yaws (K1 once a yaw,
               the edited frame within 1 uint8 level of G.synthesis at the
               CLI's batch), train_nada (4 steps, geometry frozen: (2, 0); 2
               steps --train-geometry: (2, 1); every frozen parameter
               bit-identical, the trained ones moved, the saved G reloaded),
               optimize_latent (5 steps, (1, 1)); K1 on a mapper step's inputs
               against plain (bf16 <= 1e-3) and its backward on the step's own
               cotangents (<= 1e-2 x max|grad|); VizRenderer at 48+48: 3
               uncached and 13 cached renders of every type (K1 once each,
               generate_planes once an identity), capture_layers, the page and
               /render through VizServer.handle, K1 at the render's inputs
               against plain; infer_face_animation on 8 masks with --orbit (K1
               twice a frame), converter_log_to_video on a recorded 4-edit
               session (K1 2, 1, 2, 1); run_pti + edit_comparison and a short
               experiment_runner; fp32 copies with TF32 off, card against CPU:
               CLIP's image and text embeddings (<= 1e-5 x max), a mapper
               step's and a NADA step's gradients (<= 1e-4 x max|grad|). Event
               ms per step and per render, peaks.
 12. preprocess - fp32 with TF32 off, card against CPU (<= 3e-5 x max(1,
               |output|)): P-Net on a 1024² photo's 615² pyramid level, R- and
               O-Net on 64 crops at 24² and 48², FaceReconNet on 4 crops at
               224² and its 25-dim labels, all from their seeded inits. Then
               random-init pnet/rnet/onet.pt and epoch_20.pth ({'net_recon':
               sd}) files and 4 photos (3 of the flagship's 512² renders with
               cached FFHQ-aligned detections, one 1024²); the detectors' class
               logits are biased toward 'face' (P-Net's bias solved on the
               1024² photo so that its threshold falls in a logit gap) and
               O-Net's landmarks set to a frontal layout, so that boxes pass
               all three stages: apps.preprocess_in_the_wild.main on the card
               (the cascade runs on the 1024² photo alone, finds faces that
               keep the detect_faces contract, and its biggest is cropped),
               each crop 512² with a radius-2.7 label; the cascade again on
               the card, every class probability > 1e-4 from its threshold,
               equal to its box stages on the CPU fed the card's net outputs,
               the CPU's net inputs (<= 1e-4 in [-1, 1]) and its nets' outputs
               on them (<= 3e-5 x scale) against the card's,
               apps.dataset_tool.main to a zip that ImageFolderDataset reads
               back (images and labels with the loader's flip), and
               apps.run_pti.main on crop 0 with its label (--opencv-labels;
               it must render at the dataset's c), 2 + 2 steps at TF32 on, K1
               (forward, backward) (1, 1) a projector and a PTI step and (1, 0)
               the _save_viz; ms per call of each stage (detect, FaceReconNet,
               align_crop at 224² and 512²; the cascade also warm, 5 calls
               after the CLI's), the CLI's wall per photo, event
               ms per step, peaks. Then a config-f StyleGan2Generator (1024²,
               no clamp, noise strengths 0.05) and its Discriminator from
               seeded inits, every tensor then moved by N(0, 0.01²), written as
               a TF1 (G, D, Gs) pickle of tflib Network objects and loaded by
               load_network_pkl(device="cuda"): every tensor imported and
               equal to the originals', a batch of 4 through G
               and D (fp32) card against CPU (<= 3e-5 x scale), event ms a
               batch, peaks.
 13. arch   - the optional architectures, each G full width, bf16, init(seed=0),
               written as a snapshot and read back by load_generator. Hybrid
               GeneratorConfig(use_feature_volume=True): gen_images.synth_views
               at batch 1 and 3 (event ms over 5 frames, K1 once and its
               backward never a frame, peak) beside the flagship's, the
               batch-3 frames of both in turns, the volume and each 3-D
               sampler call timed alone, K1 on a frame's inputs against plain
               (<= 1e-3), and on them with the density moved to a median of 13
               (the random hybrid's densities lie far below 0, so nearly every
               weight is 0 in fp32), the fp32 copy card vs CPU (<= 3e-5 x
               scale), one
               Painter round through PainterWebApp.handle after a warm-up (K1
               and plane_table per request as phase 6; every frame rendered
               from the cached table and volume within 1 uint8 level of
               G.synthesis), one NADA step at batch 2 with geometry frozen (K1
               (2, 0), the volume without gradient and bit-identical). The
               flagship at num_steps 64, fine_steps 128 beside 96 + 96 (event
               ms, batch 1), K1 on the 64 + 128 inputs against plain. SG3
               GeneratorConfig(sr_arch="sg3"): frames as the hybrid's, each
               filtered_lrelu call of a batch-3 frame timed alone (the fused
               kernel); at the video path's batch of 8, two frame batches
               with filtered_lrelu's counters from 0 (9 launches and no plain
               call each), and each of the stack's 9 calls on its card
               tensors through the kernel against filtered_lrelu_plain (fp32
               <= 1e-5 x max|out|; bf16 no further from the fp32 op than the
               plain bf16 op plus 2^-8 x max|out|), timed plain, fused,
               fused, plain; the fp32 copy card vs CPU. Encoder
               GeneratorConfig(use_encoder=True):
               G(cond_img=<its own render>) (event ms, K1 once),
               infer_face_animation_avatar --style-image for 8 frames (K1 once
               a frame), metric_main.calc_metric fid with cond_render at 32
               items on 32 labelled 512² images (Inception, TF32 on, K1 once a
               batch of 8).
 14. parity - K1's double backward against autograd (create_graph) through its
               plain version at B=4, R=4096, S=96+96, C=51, fp32 and bf16
               values, sorted and unsorted halves, each option, and bf16 with
               a misaligned gg_a (the streamed plan): max abs err / max|grad|
               of the value gradients and of the cotangent gradients <= 1e-4
               (fp32), <= 1e-2 (bf16), each check's launch plan read back from
               the C++; timed from CUDA graphs at the training layout beside
               its byte bound, staged and streamed in turns, the plain version
               by events. The tiny fp32 preset's PL penalty, mean length and G
               gradients at given ws and y, card against CPU (<= 1e-4 x max),
               K1 (1, 2, 1). GeneratorConfig() + Discriminator(img_channels=25),
               bf16, batch 4, pl_weight 2: 5 steps (PL on 0 and 4, R1 on 0),
               K1 (forward, backward, double backward) exactly (2, 3, 1) a PL
               step and (1, 1, 0) a plain one, finite stats, pl_mean moved;
               PL and plain steps in turns (event ms, peaks); wavelet_aa
               against the bilinear warp at ada_p 0.2, an R1 and a plain step
               each, in turns. tools/torch_make_synthetic_dataset.py writes 8
               views at 512²; apps.train_gan.main --pl-weight 2 --wavelet-aa
               --preset full --batch 4 for 2 steps on them (K1 (4, 4, 1) with
               the grid's render) and --resume of its snapshot.
 15. tools  - the trained-weight tools at full width: the flagship
               GeneratorConfig() from init(seed=0), bf16, as a snapshot, a
               HybridEncoder(512, 10, 8).init(seed=1) written by save_checkpoint
               and 16 labelled 512² views from tools/torch_make_synthetic_dataset.py.
               tools/torch_eval_trained_encoder.py --n 16 --batch 8 (K1 exactly
               twice, at B=8; its first batch's K1 inputs through kernel and
               plain, bf16 <= 1e-3; finite JSON); torch_painter_trained_demo.py
               on the encoder's inversion (K1 exactly 7 times; the three PNGs;
               the front recon within 1 uint8 level of G.synthesis);
               torch_import_and_verify.py on a reference-layout pickle of
               GeneratorConfig(vb_ref_compat=True, raw_head="slice") from
               init(seed=15), every parameter and w_avg moved by N(0, 0.01²),
               its names those io/torch_import reads (ref_layout_state): rc 0,
               every tensor imported and equal to the pickled G's, finite
               goldens, K1 8 times; --check-golden against its first run rc 0;
               a second pickle with a duplicated decoder shape rc 2.
 16. parallel - data parallelism at the full width, one rank a card spawned
               at world size torch.cuda.device_count() over NCCL, each rank
               running the paths as torchrun's ranks do (RANK, WORLD_SIZE,
               LOCAL_RANK, a fresh MASTER_PORT a call): the ray-sharded frame
               (parallel/render.make_ray_sharded_frame) of the flagship and
               the hybrid G from snapshots at B=1 and 3 against G.synthesis
               on the same card (max abs err, <= 1 uint8 level), K1 exactly
               once per rank on (B, 4096/world, 96, 52) and those inputs
               through kernel and plain (bf16 <= 1e-3), the B=3 frame's event
               ms beside G.synthesis's; gen_videos on phase 8's flagship
               snapshot and arguments (every uint8 frame equal to phase 8's,
               K1 once a chunk per rank); train_gan --preset full --batch 4
               --pl-weight 2 for 2 steps on 8 views at 512² from
               tools/torch_make_synthetic_dataset.py (the replicas checked at
               the snapshot, K1 (4, 4, 1) on rank 0 and (3, 4, 1) on the
               others) and --resume of its snapshot (every state dict
               restored); the flagship train step at global batch 4 without a
               group and with it, on one state, in turns (event ms; K1 (1, 1,
               0)); train_hybrid_encoder at batch 4 for 2 steps (K1 (6, 4, 0));
               calc_metrics fid (pixel detector) on 64 items and 64 labelled
               512² images at --batch 8 --mesh-devices world (K1 8 per rank;
               on more than one card, equal to the 1-rank fid within 1e-3).
               On a one-card machine, then world 2 on cuda:0 over gloo: the
               collectives the port runs tried on CUDA tensors (a refusal is
               printed and leaves the cross-rank checks to the CPU tests);
               if none is refused, the flagship's ray-sharded frame at B=3
               against G.synthesis (<= 1 uint8 level, K1 once per rank) and a
               tiny fp32 GAN step (R1, PL, ADA 0.3) at global batch 4 against
               the step without a group: Adam's moments within 1e-4 x each
               tensor's max, the parameters within 1e-5 x max where the
               gradient is above 1e-3 of its tensor's max, K1 (2, 3, 1) per
               rank, the replicas bit-equal. A rank that fails fails the run.
 17. serving - the serving artifact and the host loader. apps.export_model.main
               --network random:0 --batch 3 --num-steps 96 --platforms cuda
               (torch.export of the flagship's mapping and frame, K1 as the
               operator ide3d_tpu_torch::sort_integrate), load_artifact(device=
               "cuda"): the exported frame at phase 5's three yaws launches K1
               exactly once, its ws equal G.mapping's (<= 1e-5) and its img
               within 1 uint8 level of G.synthesis (max abs err and the share
               of seg argmax pixels that agree printed); the exported and the
               eager frame by CUDA events in turns, 12 each; the export and load
               seconds and the .pt2 sizes. K1's operator against the direct
               launch on the eager path in turns: K1's eager event and host ms
               at B=1, a B=1 frame's event ms, a Painter cached view's wall ms
               through PainterWebApp.handle (K1 once a view). The host ops'
               route must be "native"; PrefetchLoader at batch 4 and 4 threads
               on 8 views at 512² from tools/torch_make_synthetic_dataset.py
               (xflip): batches/s on the native and the numpy route, 5
               one-thread batches equal between them, then prefetch_to_device
               over those 5: it ends, every tensor on cuda:0 and equal to its
               host batch.
 18. flagship run - tools/torch_trained_workflow.py --run flagship (TRAINING.md's
               run B) as a user runs it, at cut counts: 8 views at 512² from
               tools/torch_make_synthetic_dataset.py; the k1 stage (one
               flagship train step at batch 4 on a dataset batch: K1 (1, 1, 0)
               counted in that step, from counts set to 0 just before it; K1
               on the step's own bf16 inputs (4, 4096, 96, 52) x 2 against
               plain (<= 1e-3) and its backward on the step's own cotangents
               against autograd through plain (<= 1e-2 x max|grad|)); train_gan
               --preset full --resolution 512 --batch 4 (the CLI's γ 13.1, PL
               off) to 0.05 kimg with pixel FID on 32 items, and its --resume
               to 0.1 kimg into the same run directory: every stats row and FID
               line finite, leg 2's rows and FID line appended to leg 1's, the
               resumed ada_p leg 1's last within one controller update, the
               grids written. The stage walls and the phase's are printed.
Then one JSON line with the kernels, and last {"ok": true, "device": {...}}.
In that line K1's `ms` and `plain_ms` are device times per call at B=3 from
the CUDA graphs; `eager_ms` is the time between CUDA events around one eager
call and `host_ms` the host's time in that call, medians at B=3; `b1` holds
the same at B=1; `launches` counts phase 5's frames, `train_launches` phase
7's steps, `video_launches` and `mesh_launches` phase 8's runs,
`metrics_launches` phase 9's per metric, `inversion_launches` phase 10's per
step of each loop, per _save_viz and in total; its `max_abs_err` is the
largest of phases 3, 5, 8, 9 and 10 (`metrics_max_abs_err` phase 9's,
`inversion_max_abs_err` phase 10's). The backward's `ms` is its graph time at
B=4, `plain_ms` the plain backward's event time, `launches` phase 7's steps,
`inversion_launches` phase 10's, `max_abs_err` relative to max|grad| (the
largest of phases 7, 10 and 11), `inversion_step_ms` phase 10's medians.
Phase 11 adds `editing_launches` (per step of each editing loop; for K1 also
per styleclip_edit yaw, face-animation frame, log-replay entry and the
edit_comparison run) and `viz_launches` to K1's entry, `editing_max_abs_err`
to both, `editing_step_ms` to the backward's; K1's `max_abs_err` also takes
phase 11's. Phase 12 adds `preprocess_launches` (per step of the run_pti
leg's loops and per _save_viz) to both and `preprocess_step_ms` to the
backward's. Phase 13 adds `arch_launches` (per frame, Painter round, metric
batch and NADA step of its paths, each read from the counts set to 0 just
before that path and read just after it) to both and `arch_max_abs_err` to
K1's; K1's `max_abs_err` also takes phase 13's. Phase 14 adds the third
entry, `sort_integrate_double_backward`: `ms` its graph time at B=4, bf16,
`plain_ms` the plain version's event time, `launches` the count over phase
14's flagship steps, `max_abs_err` relative to max|grad| over every option,
`train_step` the PL / plain and wavelet / bilinear step times and peaks; and
`parity_launches` (the counts read on phase 14's PL and plain steps, each
checked against PARITY_LAUNCHES) to the backward's and its own. The double
backward's `design` names the PR of its design, `plan` the launch plan of the
timed shape, `streamed_ms` the streamed plan's graph time on the same inputs
with gg_a misaligned. Phase 15 adds `tools_launches` (per tool run) and
`tools_max_abs_err` (the eval tool's batch-8 inputs) to K1's entry; K1's
`max_abs_err` also takes phase 15's. Phase 16 adds `parallel_launches` to
the three entries (per path, a list of the ranks' counts, and the world
size), `parallel_max_abs_err` (each rank-0 sharded frame's K1 inputs through
kernel and plain) to K1's and `parallel_step_ms` (the medians of the
data-parallel and the plain step in turns) to the backward's. Phase 17 adds
`export_launches` (the exported frame's K1 count), `exported_frame_ms` and
`eager_frame_ms` (medians in turns, batch 3) and `op_dispatch` (medians per
route) to K1's entry. Phase 18 adds `flagship_run_launches` (the k1 stage's
train step) to K1's entry and the backward's; their `max_abs_err` also take
phase 18's. The fourth entry, `filtered_lrelu` (csrc/filtered_lrelu.cu), is
phase 13's SG3 G at the video path's batch of 8, bf16: `launches` and
`plain_calls` over its two counted frame batches (9 and 0 each), `ms` the
kernel's graph time summed over the stack's 9 calls, `eager_ms` / `host_ms`
/ `plain_ms` the event and host times of one eager call summed over them,
`bound_ms` their bytes over 3.35 TB/s and `fir_bound_ms` their polyphase FIR
FLOPs over 67 TFLOP/s, `max_abs_err` the fp32 kernel against the fp32 plain
op relative to max|out|, `bf16_err` / `plain_bf16_err` the bf16 kernel's and
the plain bf16 op's against the fp32 op on the same input, `calls` each
call's numbers, `b3_frame_calls_ms` the batch-3 frame's (calls, summed ms).
Phase 13's SG3 part alone: `python3 -c "import chip_smoke as cs;
cs.phase13_sg3_alone()"`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time


def share_bytecode() -> str:
    """A bytecode cache for this process and the ones it starts, in a temporary
    directory removed at exit. Where the Python installation holds no
    `__pycache__` and PYTHONDONTWRITEBYTECODE is set (a read-only install),
    every process that imports torch and the port compiles their sources
    again, ~10 s each on an H100 host, and the run starts a dozen; the prefix
    leaves the installation untouched. An environment that sets
    PYTHONPYCACHEPREFIX keeps its own."""
    import atexit
    import shutil
    import tempfile

    if not os.environ.get("PYTHONPYCACHEPREFIX"):
        root = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = root
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        sys.dont_write_bytecode = False
    return os.environ["PYTHONPYCACHEPREFIX"]


if __name__ == "__main__":  # before torch: this process writes the cache its children read
    share_bytecode()

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEEDS = (0, 1, 2)
TIMED_RUNS = 25
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
K1_OPTIONS = (
    {}, {"clamp_mode": "relu"}, {"last_back": True}, {"white_back": True}, {"noise": True},
)


def graph_ms(fns, calls: int, runs: int = TIMED_RUNS) -> float:
    """Device time of one call, in ms: the median over `runs` replays of a CUDA
    graph that holds `calls` calls cycling through `fns`, timed by CUDA events.
    The graph keeps the host's launch overhead out of the time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    # A matmul captured on the graph's stream leaves a cuBLAS workspace
    # (32 MiB on Hopper) allocated for that stream; free it, or it counts in
    # the frame's peak memory.
    torch._C._cuda_clearCublasWorkspaces()
    return statistics.median(times)


def eager_ms(fn, runs: int = TIMED_RUNS) -> tuple[float, float]:
    """One eager call at a time, the card idle before each: the median time
    between CUDA events recorded around the call (the wrapper's host time plus
    the kernel's), and the median host time until the call returns, in ms."""
    fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    return statistics.median(events), statistics.median(host)


def k1_bytes(args) -> int:
    """Bytes K1 must move: each input read once, each output written once."""
    B, R, _, c1 = args[1].shape
    return sum(t.numel() * t.element_size() for t in args if t is not None) + B * R * (c1 + 1) * 4


def k1_counts():
    from ide3d_tpu_torch.ops import ray_march

    return (ray_march.sort_integrate.launches, ray_march.sort_integrate_backward.launches,
            ray_march.sort_integrate_double_backward.launches)


def zero_k1_counts() -> None:
    from ide3d_tpu_torch.ops import ray_march

    ray_march.sort_integrate.launches = ray_march.sort_integrate_backward.launches = 0
    ray_march.sort_integrate_double_backward.launches = 0


def k1_launches(where: str) -> tuple:
    """K1's (forward, backward) launches since zero_k1_counts(); raises if its
    double backward ran, which no path but path-length regularization runs."""
    f, b, d = k1_counts()
    if d:
        raise RuntimeError(f"{where}: K1's double backward launched {d} times, want 0")
    return f, b


def max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _check_finite(name, tensors) -> None:
    for t in tensors:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name}: non-finite output")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    share_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return smi


def phase_build() -> None:
    from ide3d_tpu_torch import _build

    t0 = time.perf_counter()
    lib, log = _build.build("ray_march")
    used, kernel = [], ""
    for ln in log.splitlines():  # ptxas -v: each entry function, then its registers
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            kind = ("double_backward_streamed" if "double_backward_streamed_kernel" in name else
                    "double_backward" if "double_backward_kernel" in name else
                    "backward" if "backward_kernel" in name else "forward")
            kernel = (f"{kind}<{'bf16' if '__nv_bfloat16' in name else 'fp32'},"
                      f"{'relu' if 'Lb1E' in name else 'softplus'}>")
        elif "spill" in ln and kernel:
            kernel += f" [{ln.strip()}]"
        elif "Used" in ln:
            used.append(f"{kernel}: {ln.split(':', 1)[1].strip()}")
    print(f"build: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{lib.name} in {time.perf_counter() - t0:.1f} s"
          f"{' (cached)' if not log else ''}; ptxas: {' | '.join(used) or 'n/a'}", flush=True)
    build_flrelu()


def build_flrelu() -> None:
    """Builds csrc/filtered_lrelu.cu; prints each instantiation's registers,
    shared memory and any spill from ptxas."""
    from ide3d_tpu_torch import _build

    t0 = time.perf_counter()
    lib, log = _build.build("filtered_lrelu")
    used, kernel = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and kernel and not ln.strip().startswith("0 bytes"):
            used.append(f"{kernel}: {ln.strip()}")
        elif "Used" in ln and kernel:
            used.append(f"{kernel}: {ln.split(':', 1)[1].strip()}")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s{' (cached)' if not log else ''}; "
          f"ptxas: {' | '.join(used) or 'n/a'}", flush=True)


def k1_inputs(gen, dtype, sigma=None, B=1, sorted_halves=False):
    """K1's inputs at the frame's shape (R=4096, S=96+96, C=51) on the card.
    `sorted_halves` gives each half ascending depths, as the deterministic
    render does; otherwise they are unsorted."""
    R, S, C = 4096, 96, 51
    dev = "cuda"

    def half():
        z = torch.rand(B, R, S, 1, generator=gen) * 1.05 + 2.25
        if sorted_halves:
            z = torch.sort(z, dim=2).values
        v = torch.randn(B, R, S, C + 1, generator=gen)
        v[..., -1] = v[..., -1] * 10 if sigma is None else sigma
        return z.to(dev), v.to(dev, dtype).contiguous()

    (za, va), (zb, vb) = half(), half()
    norm = (torch.rand(B, R, 1, generator=gen) * 0.2 + 0.9).to(dev)
    return za, va, zb, vb, norm


def _k1_options(opts, args, gen) -> dict:
    """Keyword arguments of one K1 option set; noise is drawn for these inputs."""
    kw = {k: v for k, v in opts.items() if k != "noise"}
    if opts.get("noise"):
        B, R = args[0].shape[:2]
        kw["noise"] = (torch.randn(B, R, args[0].shape[2] + args[2].shape[2], generator=gen)
                       * 2.0).cuda()
    return kw


def phase_kernel(smi: str) -> dict:
    from ide3d_tpu_torch.ops.ray_march import sort_integrate, sort_integrate_plain

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        args = k1_inputs(gen, dtype)
        for opts in K1_OPTIONS:
            kw = _k1_options(opts, args, gen)
            got, ref = sort_integrate(*args, **kw), sort_integrate_plain(*args, **kw)
            torch.cuda.synchronize()
            _check_finite(f"K1 kernel {opts}", got)
            per = [float((g - r).abs().max()) for g, r in zip(got, ref)]
            if max(per) > tol:
                raise RuntimeError(f"K1 vs plain ({dtype}, {opts}): max abs err "
                                   f"feat/depth/wsum {per} > {tol}")
            errs[f"{str(dtype).split('.')[-1]} {','.join(opts) or 'softplus'}"] = max(per)

    sat = k1_inputs(gen, torch.float32, sigma=100.0)
    feat, depth, wsum = sort_integrate(*sat)
    torch.cuda.synchronize()
    _check_finite("K1 saturated", (feat, depth, wsum))
    sat_err = float((wsum - 1.0).abs().max())
    if sat_err > 1e-4:
        raise RuntimeError(f"K1 saturated: |wsum - 1| = {sat_err}")

    # Shapes off the main path, depths rounded to 1/8 so that many samples tie
    # within and across halves, each with one option set: uneven and 1-sample
    # halves, C+1 up to 256 (streamed in row chunks), and staged shapes whose
    # channel sums take 16-byte vectors over 1, 2 or 8 rows or one channel a lane.
    edge_err = 0.0
    for n, (B, R, sa, sb, C, dtype) in enumerate((
            (2, 37, 5, 130, 3, torch.float32), (1, 5, 1, 1, 1, torch.float32),
            (1, 33, 200, 56, 255, torch.float32), (3, 100, 96, 96, 51, torch.bfloat16),
            (2, 45, 8, 16, 8, torch.bfloat16), (2, 50, 32, 32, 159, torch.float32),
            (1, 40, 8, 12, 3, torch.bfloat16), (2, 70, 64, 128, 51, torch.float32))):
        halves = []
        for s in (sa, sb):
            z = torch.round((torch.rand(B, R, s, 1, generator=gen) * 1.05 + 2.25) * 8) / 8
            v = torch.randn(B, R, s, C + 1, generator=gen)
            halves += [z.cuda(), v.to("cuda", dtype)]
        norm = (torch.rand(B, R, 1, generator=gen) + 0.5).cuda()
        args = (*halves, norm)
        for opts in (K1_OPTIONS[0], K1_OPTIONS[1 + n % (len(K1_OPTIONS) - 1)]):
            kw = _k1_options(opts, args, gen)
            edge_err = max(edge_err, max_err(sort_integrate(*args, **kw),
                                             sort_integrate_plain(*args, **kw)))
    if edge_err > 1e-4:
        raise RuntimeError(f"K1 vs plain off the main path's shapes: max abs err {edge_err}")

    # Times at the frame's shape and dtype, sorted halves as the frame has them.
    # Two input sets in turn, so that B=1 (86 MB) does not run from the 50 MB L2.
    timing = {}
    for B in (1, 3):
        sets = [k1_inputs(gen, torch.bfloat16, B=B, sorted_halves=True) for _ in range(2)]
        kern = [lambda a=a: sort_integrate(*a) for a in sets]
        plain = [lambda a=a: sort_integrate_plain(*a) for a in sets]
        t = [graph_ms(kern, 20), graph_ms(plain, 4), graph_ms(plain, 4), graph_ms(kern, 20)]
        eager, host = eager_ms(kern[0])
        nbytes = k1_bytes(sets[0])
        bound_ms = nbytes / HBM_BYTES_PER_MS
        timing[B] = {"ms": min(t[0], t[3]), "plain_ms": min(t[1], t[2]), "eager_ms": eager,
                     "host_ms": host, "bytes": nbytes, "bound_ms": bound_ms,
                     "bound_share": bound_ms / min(t[0], t[3])}
        print(f"kernel: K1 bf16 B={B} R=4096 S=96+96 C=51: kernel {t[0]:.4f}/{t[3]:.4f} ms, "
              f"plain {t[1]:.4f}/{t[2]:.4f} ms; {nbytes} B, bound {bound_ms * 1e3:.2f} us at "
              f"3.35 TB/s, {100 * timing[B]['bound_share']:.1f}% of the bound; eager call "
              f"{eager:.4f} ms, of it host {host:.4f} ms ({smi})", flush=True)
        del sets, kern, plain
    print(f"kernel: K1 vs plain max abs err {errs}; saturated |wsum-1| {sat_err:.3g}; "
          f"edge shapes {edge_err:.3g}", flush=True)
    return {"max_abs_err": max(edge_err, sat_err, *errs.values()), "timing": timing}


def fp32_card_vs_cpu(cfg, seed: int, label: str) -> dict:
    """One fp32 frame of Ide3dGenerator(cfg).init(seed) at batch 1, the card
    (K1) against the CPU (plain paths) on the same weights, TF32 off on both
    sides: max abs err <= 3e-5 x the output's scale. Returns the errors."""
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    z = torch.as_tensor(np.random.RandomState(0).randn(1, cfg.z_dim), dtype=torch.float32)
    c = torch.as_tensor(CANONICAL_POSE_25)[None]
    outs = {}
    for dev in ("cpu", "cuda"):
        G = Ide3dGenerator(cfg).init(seed=seed).to(dev).eval()
        with torch.inference_mode():
            outs[dev] = G(z.to(dev), c.to(dev), return_all=True)
    err, scale = {}, {}
    for k in ("img", "seg", "depth", "weights_sum"):
        ref = outs["cpu"][k]
        err[k] = float((outs["cuda"][k].cpu() - ref).abs().max())
        scale[k] = max(1.0, float(ref.abs().max()))
    _check_finite(f"{label} fp32 frame", [outs["cuda"][k] for k in err])
    if any(err[k] > 3e-5 * scale[k] for k in err):
        raise RuntimeError(f"{label} fp32 frame cuda vs cpu: max abs err {err}, output scale {scale}")
    return {"err": err, "scale": scale}


def phase_fp32() -> None:
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    r = fp32_card_vs_cpu(GeneratorConfig(dtype="float32"), 0, "flagship")
    print(f"fp32: GeneratorConfig(dtype=float32) batch 1, cuda (K1) vs cpu (plain): max abs err "
          f"{r['err']} at output scale {r['scale']} (limit 3e-5 x scale)", flush=True)


def phase_frame() -> dict:
    from ide3d_tpu_torch.apps import gen_images
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.render.renderer import RenderParams

    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    G = Ide3dGenerator(cfg).init(seed=0).to("cuda").eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rp = RenderParams(img_size=cfg.render_size, num_steps=96, hierarchical=True)
    cams = gen_images.yaw_cameras("cuda")
    cs = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.inference_mode():
        ws = {s: G.mapping(torch.as_tensor(np.random.RandomState(s).randn(1, cfg.z_dim),
                                           dtype=torch.float32, device="cuda"), cs) for s in SEEDS}
    gen_images.synth_views(G, ws[SEEDS[0]], cams, rp)  # warm-up: cuDNN heuristics, allocator
    torch.cuda.synchronize()

    # The main path, counted: the gen_images batch for each seed.
    torch.cuda.reset_peak_memory_stats()
    zero_k1_counts()
    times, outs = [], []
    for s in SEEDS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        img, seg, seg_rgb = gen_images.synth_views(G, ws[s], cams, rp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        outs.append((img, seg, seg_rgb))
    launches = k1_launches("gen_images")[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    R = cfg.img_resolution
    for img, seg, seg_rgb in outs:
        if tuple(img.shape) != (3, R, R, 3) or tuple(seg.shape) != (3, R, R, 19):
            raise RuntimeError(f"frame shapes img {tuple(img.shape)} seg {tuple(seg.shape)}")
        _check_finite("frame", (img, seg))
        if torch.equal(img[0], img[2]):
            raise RuntimeError("frame: the -0.5 and +0.5 yaw views are identical")
    if launches != len(SEEDS):
        raise RuntimeError(f"K1 launched {launches} times for {len(SEEDS)} frames")

    # One frame's K1 inputs, captured at the renderer's call, through kernel and plain.
    captured = []

    def capture(*args, **kw):
        captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = capture
    try:
        gen_images.synth_views(G, ws[SEEDS[0]], cams, rp)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = captured
    with torch.inference_mode():
        frame_err = max_err(ray_march.sort_integrate(*args, **kw),
                            ray_march.sort_integrate_plain(*args, **kw))
    if frame_err > 1e-3:
        raise RuntimeError(f"K1 vs plain on a frame's inputs: max abs err {frame_err}")
    # Rays whose coarse / fine half arrives sorted take the binary-search rank.
    sorted_share = [float((z[:, :, 1:] >= z[:, :, :-1]).all(2).float().mean())
                    for z in (args[0], args[2])]
    with torch.inference_mode():
        k1_frame_ms = graph_ms([lambda: ray_march.sort_integrate(*args, **kw)], 20)

    print(f"frame: GeneratorConfig() bf16 96+96, batch of 3 yaws x {len(SEEDS)} seeds: "
          f"img {tuple(outs[0][0].shape)} seg {tuple(outs[0][1].shape)} finite; "
          f"frame ms {[round(t, 3) for t in times]} median {statistics.median(times):.3f}; "
          f"peak {peak_gib:.3f} GiB; init {init_s:.1f} s; K1 launches {launches}; "
          f"K1 on captured frame inputs (vals {args[1].dtype}, {tuple(args[1].shape)}+"
          f"{tuple(args[3].shape)}) max abs err vs plain {frame_err:.3g}, "
          f"{k1_frame_ms:.4f} ms; rays with a sorted coarse / fine half {sorted_share}", flush=True)
    return {"launches": launches, "frame_err": frame_err, "k1_frame_ms": k1_frame_ms}, G


# The Painter's requests, in order: (route, method, path, query, payload,
# K1 launches, plane_table calls). Every G pass launches K1 once; a view
# of the latent whose planes are cached generates none. "mask" payloads get
# the painted mask of that step.
PAINTER_REQUESTS = (
    ("meta", "GET", "/api/meta", None, None, 0, 0),
    ("seed", "POST", "/api/seed", None, {"seed": 3, "trunc": 0.7}, 1, 1),
    ("cached view", "GET", "/api/view", {"yaw": "0.3"}, None, 1, 0),
    ("cached view", "GET", "/api/view", {"yaw": "-0.3"}, None, 1, 0),
    ("uncached edit", "POST", "/api/edit", None, {"mask": 0, "yaw": 0.1}, 2, 2),
    ("stroke", "POST", "/api/edit", None, {"mask": 1, "yaw": 0.1}, 1, 1),
    ("stroke", "POST", "/api/edit", None, {"mask": 2, "yaw": 0.1}, 1, 1),
    ("view of edited latent", "GET", "/api/view", {"yaw": "0.1"}, None, 1, 1),
    ("orbit", "POST", "/api/orbit", None, {"type": "orbit", "stride": 10}, 12, 1),
)
PAINTER_ROUNDS = 3  # timed rounds of PAINTER_REQUESTS after the warm-up round
EVENT_RUNS = 7  # session calls timed by CUDA events, per kind


def painter_masks(seg_ids: np.ndarray, R: int) -> list:
    """The seed's class ids with a hair rectangle (class 13), then two more
    strokes on top: skin, then hair again."""
    m = [seg_ids.reshape(R, R).copy()]
    m[0][R // 8: R // 2, R // 4: 3 * R // 4] = 13
    for cls, box in ((1, (R // 2, 5 * R // 8, R // 3, R // 2)), (13, (R // 16, R // 8, R // 3, 2 * R // 3))):
        m.append(m[-1].copy())
        m[-1][box[0]:box[1], box[2]:box[3]] = cls
    return m


def _decode_png(b64: str, R: int) -> None:
    import base64
    import io

    import PIL.Image

    img = PIL.Image.open(io.BytesIO(base64.b64decode(b64)))
    img.load()
    if img.size != (R, R):
        raise RuntimeError(f"painter: PNG of size {img.size}, want {(R, R)}")


def painter_round(app, counts: dict, check: bool) -> list:
    """PAINTER_REQUESTS once through app.handle, every count set to 0 before
    each request and read after it. Returns [(route, wall ms, K1, planes, K1's
    backward)], the counts as read, and the orbit video's file type."""
    import base64

    from ide3d_tpu_torch.apps import painter

    R = app.session.G.cfg.img_resolution
    finite, masks, rows, ext = [], None, [], None
    to_u8 = painter._img_u8
    if check:  # every image a request renders, before its uint8 conversion
        painter._img_u8 = lambda img: (finite.append(torch.isfinite(img).all()), to_u8(img))[1]
    try:
        for route, method, path, query, payload, k1, planes in PAINTER_REQUESTS:
            if payload is not None and "mask" in payload:
                payload = dict(payload, mask=base64.b64encode(masks[payload["mask"]].reshape(-1)).decode())
            body = json.dumps(payload).encode() if payload is not None else b""
            zero_k1_counts()
            counts["planes"] = 0
            t0 = time.perf_counter()
            status, ctype, reply = app.handle(method, path, query or {}, body)
            ms = (time.perf_counter() - t0) * 1e3
            fwd, bwd = k1_launches(f"painter {route}")
            got = (fwd, counts["planes"])
            if status != 200:
                raise RuntimeError(f"painter {route}: status {status}: {reply[:300]!r}")
            if got != (k1, planes):
                raise RuntimeError(f"painter {route}: K1 launches, plane_table calls {got}, "
                                   f"want {(k1, planes)}")
            out = json.loads(reply)
            rows.append((route, ms, *got, bwd))
            if "render" in out:
                _decode_png(out["render"], R)
            if "seg_ids" in out and len(base64.b64decode(out["seg_ids"])) != R * R:
                raise RuntimeError(f"painter {route}: seg_ids are not {R}x{R}")
            if route == "seed":
                masks = painter_masks(np.frombuffer(base64.b64decode(out["seg_ids"]), np.uint8), R)
            if route == "meta" and out["resolution"] != R:
                raise RuntimeError(f"painter meta: resolution {out['resolution']}")
            if route == "orbit":
                if out["frames"] != 12:
                    raise RuntimeError(f"painter orbit: {out['frames']} frames, want 12")
                ext = out["ext"]
                if out["ext"] == "gif":
                    import io

                    import PIL.Image

                    gif = PIL.Image.open(io.BytesIO(base64.b64decode(out["video"])))
                    if gif.n_frames != 12 or gif.size != (R, R):
                        raise RuntimeError(f"painter orbit: GIF {gif.n_frames} x {gif.size}")
    finally:
        painter._img_u8 = to_u8
    if check:
        images = sum(12 if r[0] == "orbit" else r[0] != "meta" for r in PAINTER_REQUESTS)
        if len(finite) != images or not all(bool(f) for f in finite):
            raise RuntimeError(f"painter: {len(finite)} images, finite {[bool(f) for f in finite]}")
        _check_finite("painter latent", [app.session.w])
    return rows, ext


def event_median_ms(fn, runs: int = EVENT_RUNS) -> float:
    """Median time between CUDA events around one call, the card idle before each."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_painter(G, smi: str) -> dict:
    import copy

    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.apps.web_ui import PainterWebApp
    from ide3d_tpu_torch.models.encoder import HybridEncoder
    from ide3d_tpu_torch.utils.seg import COLOR_MAP, mask2onehot

    R = G.cfg.img_resolution
    n_geo = G.synthesis.num_ws_geo  # 8 geometry rows, 10 appearance rows, as web_ui builds E
    t0 = time.perf_counter()
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      dtype=G.cfg.dtype).init(seed=1)
    sess = PainterSession(G=G, E=E.to("cuda").eval(), device="cuda")
    app = PainterWebApp(sess)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    S = G.synthesis
    counts = {"planes": 0}
    plane_table = S.plane_table

    def counted_planes(*args, **kw):
        counts["planes"] += 1
        return plane_table(*args, **kw)

    S.plane_table = counted_planes
    try:
        _, video_ext = painter_round(app, counts, check=True)  # warm-up, finiteness checks
        torch.cuda.reset_peak_memory_stats()
        rounds = [painter_round(app, counts, check=False)[0] for _ in range(PAINTER_ROUNDS)]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        del S.plane_table
    wall, launches = {}, {}
    for rows in rounds:
        for route, ms, k1, *_ in rows:
            wall.setdefault(route, []).append(ms)
            launches[route] = k1
    wall_med = {route: statistics.median(v) for route, v in wall.items()}
    k1_round = sum(r[2] for r in rounds[0])

    # Session calls alone, CUDA events: stroke (E + 1 G), uncached edit (E + 2 G),
    # cached view (1 G), E alone.
    masks = painter_masks(np.zeros(R * R, np.uint8), R)  # all background, then strokes
    sess.set_seed(3)
    sess.edit(masks[0], 0.1)
    ev = {"stroke": event_median_ms(lambda: sess.edit(masks[1], 0.1))}

    def uncached():
        sess._frame_cache = None
        sess.edit(masks[1], 0.1)

    ev["uncached edit"] = event_median_ms(uncached)
    sess.view(0.2)
    ev["cached view"] = event_median_ms(lambda: sess.view(0.2))
    gen_img = sess._frame_cache[2]
    seg_pm = mask2onehot(torch.from_numpy(masks[2]).cuda()[None]) * 2.0 - 1.0
    with torch.inference_mode():
        ev["E"] = event_median_ms(lambda: E(gen_img, seg_pm))

    # A cached view against the uncached frame of the same ws and c.
    sess.view(0.3)
    with torch.inference_mode():
        ref = G.synthesis(sess.w, sess.camera(0.3), return_seg=True)[0]
    view_err = float((sess._frame_cache[2] - ref).abs().max())
    _check_finite("painter cached view", [ref])
    if view_err > 1e-3:
        raise RuntimeError(f"painter: cached view vs G.synthesis max abs err {view_err} > 1e-3")

    # A stroke (frame cache) against the same edit without the frame cache.
    def edit_pair(use_cache):
        sess.set_seed(3)
        sess.edit(masks[0], 0.1)
        if not use_cache:
            sess._frame_cache = None
        rgb, seg = sess.edit(masks[1], 0.1)
        return rgb.astype(np.int32), seg.astype(np.int32), sess.w.clone()

    (rgb_c, seg_c, w_c), (rgb_u, seg_u, w_u) = edit_pair(True), edit_pair(False)
    _check_finite("painter stroke", [w_c, w_u])
    stroke_err = {"rec_ws": float((w_c - w_u).abs().max()),
                  "rgb": int(np.abs(rgb_c - rgb_u).max()), "seg": int(np.abs(seg_c - seg_u).max())}
    if stroke_err["rec_ws"] > 1e-3 or stroke_err["rgb"] > 1 or stroke_err["seg"] > 1:
        raise RuntimeError(f"painter: stroke vs uncached edit {stroke_err}")

    # The web UI's colour -> class-id inversion of a 512^2 seg, against the
    # nearest-colour search of the JAX package's web UI: same ids, host ms each.
    seg_color = sess.view(0.0)[1]
    t0 = time.perf_counter()
    ids = PainterWebApp._seg_ids(seg_color)
    lookup_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pal = COLOR_MAP.astype(np.int32)
    nearest = np.abs(seg_color.astype(np.int32)[:, :, None, :] - pal).sum(-1).argmin(-1)
    search_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(ids, nearest.reshape(-1)):
        raise RuntimeError("painter: palette lookup and nearest-colour search disagree")

    # The fp32 encoder at batch 1, card against CPU on the same weights (TF32 off).
    E32 = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo).init(seed=1)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, R, R, 3)).astype(np.float32))
    seg = mask2onehot(torch.from_numpy(rng.randint(0, 19, (1, R, R)))) * 2.0 - 1.0
    with torch.inference_mode():
        e_ref = E32(img, seg)
        e_got = copy.deepcopy(E32).cuda()(img.cuda(), seg.cuda()).cpu()
    _check_finite("fp32 encoder", [e_got])
    e_scale = max(1.0, float(e_ref.abs().max()))
    e_err = float((e_got - e_ref).abs().max())
    if e_err > 3e-5 * e_scale:
        raise RuntimeError(f"painter: fp32 encoder cuda vs cpu max abs err {e_err}, scale {e_scale}")

    print(f"painter: {smi}; G {R}^2 {G.cfg.dtype} + HybridEncoder({R}, {G.num_ws - n_geo}, "
          f"{n_geo}, {G.cfg.dtype}) through "
          f"PainterWebApp.handle, {PAINTER_ROUNDS} rounds after a warm-up; wall ms per route "
          f"(median, PNG encoding included) {json.dumps({k: round(v, 3) for k, v in wall_med.items()})} "
          f"(samples {json.dumps({k: len(v) for k, v in wall.items()})}); "
          f"CUDA-event ms of the session call (median of {EVENT_RUNS}) "
          f"{json.dumps({k: round(v, 3) for k, v in ev.items()})}; peak {peak_gib:.3f} GiB; "
          f"init {init_s:.1f} s; K1 launches per request {json.dumps(launches)}, "
          f"{k1_round} a round, plane_table as listed; orbit video .{video_ext}; seg colour -> "
          f"ids {lookup_ms:.3f} ms (nearest-colour search {search_ms:.3f} ms); cached view vs G.synthesis "
          f"{view_err:.3g}; stroke vs uncached edit {stroke_err}; fp32 E cuda vs cpu "
          f"{e_err:.3g} at scale {e_scale:.3g}", flush=True)
    return {"launches": launches, "per_round": k1_round, "wall_ms": wall_med, "event_ms": ev,
            "peak_gib": peak_gib, "max_abs_err": max(view_err, stroke_err["rec_ws"])}


TRAIN_STEPS = 6  # full-width train steps of phase 7; step 0 applies R1
TRAIN_ADA_P = 0.2


def k1_backward_bytes(args, cot) -> int:
    """Bytes K1's backward must move: the forward's inputs and the cotangents
    read once, a gradient as large as the values written once."""
    return (sum(t.numel() * t.element_size() for t in (*args, *cot) if t is not None)
            + args[1].numel() * args[1].element_size() + args[3].numel() * args[3].element_size())


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over a list of tensor pairs."""
    scale = max(float(r.float().abs().max()) for r in ref)
    return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)) / scale


def _k1_cotangents(gen, args):
    B, R, _, c1 = args[1].shape
    return [torch.randn(B, R, n, generator=gen).cuda() for n in (c1 - 1, 1, 1)]


def training_k1_sets(gen, n: int = 2) -> list:
    """n (args, cotangents) pairs at the training render's K1 inputs: bf16, B=4,
    coarse half sorted (jittered within its bins), fine half unsorted (random
    CDF positions)."""
    sets = []
    for _ in range(n):
        a = k1_inputs(gen, torch.bfloat16, B=4, sorted_halves=True)
        fine = k1_inputs(gen, torch.bfloat16, B=4)
        args = (a[0], a[1], fine[2], fine[3], a[4])
        sets.append((args, _k1_cotangents(gen, args)))
    return sets


def train_k1_backward(smi: str) -> dict:
    """K1's backward at the training render's shape (B=4) against autograd
    through the plain version, every option, then timed."""
    from ide3d_tpu_torch.ops.ray_march import (sort_integrate, sort_integrate_backward,
                                               sort_integrate_backward_plain)

    gen = torch.Generator().manual_seed(7)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        for sorted_halves in (False, True):
            args = k1_inputs(gen, dtype, B=4, sorted_halves=sorted_halves)
            cot = _k1_cotangents(gen, args)
            for opts in K1_OPTIONS:
                kw = _k1_options(opts, args, gen)
                got = sort_integrate_backward(*args, *cot, **kw)
                ref = sort_integrate_backward_plain(*args, *cot, **kw)
                torch.cuda.synchronize()
                _check_finite(f"K1 backward {opts}", [g.float() for g in got])
                err = rel_err(got, ref)
                name = f"{str(dtype).split('.')[-1]} {'sorted' if sorted_halves else 'unsorted'} " \
                       f"{','.join(opts) or 'softplus'}"
                if err > tol or any(g.dtype != r.dtype for g, r in zip(got, ref)):
                    raise RuntimeError(f"K1 backward vs plain ({name}): max abs err / max|grad| "
                                       f"{err} > {tol}")
                errs[name] = err
            del args, cot

    # Timed at the training render's inputs, two sets.
    sets = training_k1_sets(gen)
    bwd = [lambda s=s: sort_integrate_backward(*s[0], *s[1]) for s in sets]
    both = [lambda s=s: (sort_integrate(*s[0]), sort_integrate_backward(*s[0], *s[1])) for s in sets]
    fwd = [lambda s=s: sort_integrate(*s[0]) for s in sets]
    t_bwd = [graph_ms(bwd, 10), graph_ms(bwd, 10)]
    t_both = [graph_ms(both, 10), graph_ms(both, 10)]
    t_fwd = graph_ms(fwd, 10)
    plain = [event_median_ms(lambda: sort_integrate_backward_plain(*s[0], *s[1]), runs=5) for s in sets]
    bwd_bytes = k1_backward_bytes(*sets[0])
    fwd_bytes = k1_bytes(sets[0][0])
    out = {"max_abs_err": max(errs.values()), "errs": errs, "ms": min(t_bwd),
           "plain_ms": min(plain), "bound_ms": bwd_bytes / HBM_BYTES_PER_MS, "bytes": bwd_bytes,
           "fwd_bwd_ms": min(t_both), "fwd_bwd_bound_ms": (bwd_bytes + fwd_bytes) / HBM_BYTES_PER_MS,
           "fwd_ms_b4": t_fwd, "fwd_bound_ms_b4": fwd_bytes / HBM_BYTES_PER_MS}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"train: K1 backward bf16 B=4 R=4096 S=96+96 C=51 (coarse sorted, fine unsorted): "
          f"{t_bwd[0]:.4f}/{t_bwd[1]:.4f} ms, {bwd_bytes} B, bound {out['bound_ms'] * 1e3:.1f} us "
          f"({100 * out['bound_share']:.1f}% of it); forward + backward {t_both[0]:.4f}/{t_both[1]:.4f} "
          f"ms, bound {out['fwd_bwd_bound_ms'] * 1e3:.1f} us; forward alone {t_fwd:.4f} ms "
          f"(bound {out['fwd_bound_ms_b4'] * 1e3:.1f} us); plain backward (autograd, event ms) "
          f"{[round(p, 4) for p in plain]} ({smi}); vs plain, max abs err / max|grad| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} "
          f"(limits fp32 1e-4, bf16 1e-2)", flush=True)
    return out


def _tiny_gan(device: str):
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    G = Ide3dGenerator(PRESETS["tiny"]).init(0).to(device)
    D = Discriminator(DiscriminatorConfig(img_resolution=32, img_channels=25, channel_base=512,
                                          channel_max=32, dtype="float32")).init(1).to(device)
    for name, p in G.named_parameters():  # non-zero layer noise: the const noise enters
        if name.endswith("noise_strength"):
            p.data.fill_(0.3)
    return G, D


def train_card_vs_cpu() -> dict:
    """fp32 tiny preset, the deterministic render, fixed z: g-loss, d-loss and
    R1 (through ADA at fixed draws) and their gradients, card against CPU."""
    import functools

    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.train import augment, gan

    rng = np.random.RandomState(3)
    B, R = 4, 32
    z = torch.from_numpy(rng.randn(B, 512).astype(np.float32))
    real_img = torch.from_numpy(rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32))
    real_seg = torch.from_numpy(rng.randint(0, 19, (B, R, R)).astype(np.uint8))
    c = torch.as_tensor(CANONICAL_POSE_25)[None].repeat(B, 1)
    tcfg = gan.GanTrainConfig(aug=augment.AugmentConfig(compute_dtype="float32"))
    gen = torch.Generator().manual_seed(5)
    Gm = augment._geometry_matrix(gen, 0.5, tcfg.aug, B, R, R)
    Cm = augment._color_matrix(gen, 0.5, tcfg.aug, B)
    res = {}
    for dev in ("cpu", "cuda"):
        G, D = _tiny_gan(dev)
        batch = gan.expand_compact_batch({"img": real_img.to(dev), "seg": real_seg.to(dev)})
        plain_in = functools.partial(gan.d_input, tcfg=tcfg, gen=None, ada_p=0.0)

        def ada_in(triple, Gm=Gm.to(dev), Cm=Cm.to(dev)):
            return torch.cat(augment.apply_augment(*triple, Gm, Cm, None, tcfg.aug), dim=-1)

        def grads(loss, module):  # the used parameters' gradients, in a fixed order
            gs = torch.autograd.grad(loss, list(module.parameters()), allow_unused=True)
            return [g for g in gs if g is not None]

        lg, _, fakes = gan.g_loss(G, D, z.to(dev), c.to(dev), tcfg, None, plain_in)
        real = gan.d_triple_real(batch["img"], batch["seg"], G.cfg.render_size)
        ld, _ = gan.d_loss(D, fakes, real, c.to(dev), plain_in)
        r1 = gan.r1_penalty(D, real, c.to(dev), ada_in)
        res[dev] = {"values": [lg.detach(), ld.detach(), r1.detach()], "g": grads(lg, G),
                    "d": grads(ld, D), "r1": grads(r1, D)}
    err = {"values": rel_err([v.cpu() for v in res["cuda"]["values"]], res["cpu"]["values"])}
    for k in ("g", "d", "r1"):
        err[k] = rel_err([g.cpu() for g in res["cuda"][k]], res["cpu"][k])
    print(f"train: tiny fp32 G/D, deterministic render, card (K1 + its backward) vs CPU (plain): "
          f"losses g/d/R1 {[round(float(v), 6) for v in res['cuda']['values']]}; max abs err / "
          f"max|x| {json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})} (limit 1e-4)", flush=True)
    if max(err.values()) > 1e-4:
        raise RuntimeError(f"train: card vs CPU {err}")
    return err


def synthetic_batch(B: int, R: int, seed: int) -> dict:
    """A compact (uint8) batch of B random R² images and seg ids, with the
    three yaws of gen_images as cameras, on the card."""
    from ide3d_tpu_torch.apps import gen_images

    rng = np.random.RandomState(seed)
    cams = gen_images.yaw_cameras("cuda")
    return {"img": torch.from_numpy(rng.randint(0, 256, (B, R, R, 3), np.uint8)).cuda(),
            "seg": torch.from_numpy(rng.randint(0, 19, (B, R, R), np.uint8)).cuda(),
            "c": cams[torch.arange(B) % cams.shape[0]].contiguous()}


def train_full_width(smi: str) -> dict:
    """TRAIN_STEPS of make_gan_train_step at the flagship width, batch 4."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.train import gan

    B, cfg = 4, GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / B)
    G = Ide3dGenerator(cfg).init(seed=0).cuda()
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg))).init(1).cuda()
    state = gan.init_gan_state(G, D, tcfg)
    step = gan.make_gan_train_step(tcfg)
    batch = synthetic_batch(B, cfg.img_resolution, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = {n: [p.detach().clone() for p in m.parameters()] for n, m in (("G", G), ("D", D))}
    torch.cuda.synchronize()

    # The main path, counted: each step's K1 launches, forward and backward.
    torch.cuda.reset_peak_memory_stats()
    times, launches, stats = [], [], []
    for _ in range(TRAIN_STEPS):
        zero_k1_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, s = step(state, batch, gen, TRAIN_ADA_P)
        end.record()
        end.synchronize()
        launches.append(k1_launches("train step"))
        times.append(start.elapsed_time(end))
        stats.append({k: float(v) for k, v in s.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for i, s in enumerate(stats):
        if not all(np.isfinite(v) for v in s.values()):
            raise RuntimeError(f"train step {i}: non-finite stats {s}")
        if (s["r1_penalty"] > 0) != (i % tcfg.r1_interval == 0):
            raise RuntimeError(f"train step {i}: R1 {s['r1_penalty']} off its cadence")
    if any(n != (1, 1) for n in launches):
        raise RuntimeError(f"K1 (forward, backward) launches per train step {launches}, want (1, 1)")
    with torch.no_grad():
        moved = {n: sum(float((p - q).abs().sum()) for p, q in zip(m.parameters(), before[n]))
                 for n, m in (("G", G), ("D", D))}
        ema_gap = sum(float((p - q).abs().sum())
                      for p, q in zip(state.G_ema.parameters(), G.parameters()))
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"train: parameters did not move {moved}")
    if not ema_gap > 0:
        raise RuntimeError("train: G_ema equals G")

    # One more R1 step after the warm-up, timed alone.
    state.step = tcfg.r1_interval
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, s = step(state, batch, gen, TRAIN_ADA_P)
    end.record()
    end.synchronize()
    warm_r1 = start.elapsed_time(end)
    if not float(s["r1_penalty"]) > 0:
        raise RuntimeError("train: the warm R1 step applied no R1")
    med = statistics.median(times[1:])
    print(f"train: GeneratorConfig() bf16 96+96 + Discriminator(img_channels=25) bf16, batch 4, "
          f"ada_p {TRAIN_ADA_P}, {TRAIN_STEPS} steps of make_gan_train_step ({smi}): step ms "
          f"{[round(t, 3) for t in times]} (step 0 with R1 and the first calls; median of the "
          f"others {med:.3f}); a warm R1 step {warm_r1:.3f} ms; peak {peak_gib:.3f} GiB; K1 "
          f"(forward, backward) launches per step {launches}; losses per step "
          f"{[{k: round(v, 4) for k, v in s.items()} for s in stats]}; |dparam| sums {moved}", flush=True)
    return {"launches": launches, "step_ms": times, "median_ms": med, "r1_step_ms": times[0],
            "warm_r1_step_ms": warm_r1, "peak_gib": peak_gib, "imgs_per_s": B / med * 1e3}


def write_dataset(root: str, n: int, R: int) -> tuple:
    """n random R² PNGs with seg masks and a dataset.json of yaw cameras."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import gen_images

    imgs, segs = os.path.join(root, "imgs"), os.path.join(root, "segs")
    os.makedirs(imgs)
    os.makedirs(segs)
    rng = np.random.RandomState(1)
    cams = gen_images.yaw_cameras("cpu").numpy()
    labels = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(os.path.join(imgs, name))
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(os.path.join(segs, name))
        label = cams[i % len(cams)].copy()
        label[[1, 2, 5, 6, 9, 10]] *= -1  # stored OpenCV-convention, flipped on load
        labels[name] = label.tolist()
    with open(os.path.join(imgs, "dataset.json"), "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return imgs, segs


def _same_state(a: dict, b: dict, path: str = "") -> None:
    """Every tensor of two (nested) state dicts equal; raises with the first difference."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"resume: keys of {path} differ")
        for k in a:
            _same_state(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise RuntimeError(f"resume: {path} differs")
    elif a != b:
        raise RuntimeError(f"resume: {path} {a} != {b}")


def train_entry_point() -> dict:
    """apps.train_gan.main for 2 steps on an 8-image 512² dataset, then a
    resume of its final snapshot that restores every state dict."""
    import os
    import tempfile

    from ide3d_tpu_torch.apps import train_gan
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as root:
        imgs, segs = write_dataset(root, 8, 512)
        common = ["--data", imgs, "--seg", segs, "--preset", "full", "--batch", "4",
                  "--kimg", "0.008", "--fixed-ada-p", str(TRAIN_ADA_P), "--device", "cuda"]
        t0 = time.perf_counter()
        first = train_gan.main(common + ["--outdir", os.path.join(root, "run"), "--metrics", "fid",
                                         "--metric-items", "16", "--metric-detector", "inception"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        snap = os.path.join(root, "run", "snapshot-final")
        files = sorted(os.listdir(os.path.join(root, "run")))
        with open(os.path.join(root, "run", "metric-fid.jsonl")) as fh:
            fid_lines = [json.loads(ln) for ln in fh.read().splitlines()]
        if len(fid_lines) != 1 or fid_lines[0]["kimg"] != 0.008 \
                or not np.isfinite(fid_lines[0]["results"]["fid"]):
            raise RuntimeError(f"train_gan --metrics fid: metric-fid.jsonl holds {fid_lines}")
        saved, meta = load_checkpoint(snap)
        if first.step != 2 or meta["step"] != 2 or meta["ada_p"] != TRAIN_ADA_P:
            raise RuntimeError(f"train_gan: step {first.step}, meta {meta.get('step')}, "
                               f"ada_p {meta.get('ada_p')}")
        resumed = train_gan.main(common + ["--outdir", os.path.join(root, "resumed"),
                                           "--resume", snap])
        for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
            obj = getattr(resumed, name)
            _same_state(saved[name], obj.state_dict(), name)
            _same_state(getattr(first, name).state_dict(), obj.state_dict(), name)
        _same_state(saved["pl_mean"], resumed.pl_mean, "pl_mean")
        if resumed.step != 2:
            raise RuntimeError(f"train_gan --resume: step {resumed.step}, want 2")
    print(f"train: apps.train_gan.main --preset full --batch 4 --kimg 0.008 --metrics fid "
          f"--metric-items 16 --metric-detector inception on 8 images: 2 steps in {run_s:.1f} s "
          f"(G and D init, grid, snapshot and the FID included), FID {fid_lines[0]['results']['fid']:.6g} "
          f"at kimg {fid_lines[0]['kimg']} in {fid_lines[0]['total_time']:.3f} s, wrote {files}; --resume "
          f"of snapshot-final restored G, D, G_ema, opt_g, opt_d, pl_mean, step 2, ada_p "
          f"{meta['ada_p']}", flush=True)
    return {"run_s": run_s}


def phase_train(smi: str) -> dict:
    k = train_k1_backward(smi)
    e = train_card_vs_cpu()
    t = train_full_width(smi)
    a = train_entry_point()
    return {"k1_backward": k, "card_vs_cpu": e, "full": t, "app": a}


# Phase 8's video: 2 keyframes x 8 frames, rendered 8 frames a chunk (K1 once a chunk).
VIDEO_ARGS = ("--seeds", "0-1", "--grid", "1x1", "--num-keyframes", "2", "--w-frames", "8",
              "--chunk", "8", "--device", "cuda")
VIDEO_FRAMES, VIDEO_CHUNK = 16, 8
MESH_FRAMES = 8


def write_snapshot(path: str, cfg, seed: int) -> None:
    """Ide3dGenerator(cfg).init(seed) as train_gan writes a snapshot:
    {"G_ema": state dict} and the config, through io/checkpoint."""
    from ide3d_tpu_torch.io.checkpoint import save_checkpoint
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    save_checkpoint(path, {"G_ema": Ide3dGenerator(cfg).init(seed=seed).state_dict()}, config=cfg,
                    step=0)


def offline_video(snap: str, mode: str, out: str, smi: str, label: str) -> dict:
    """apps.gen_videos.main on the snapshot, once to warm up and once counted:
    K1 once a chunk, 16 frames written, frame 0 within 1 uint8 level of
    G.synthesis on the same w+ and camera (in the chunk's batch, through the
    CLI's own epilogue); the warm-up's first-chunk K1 inputs, captured at the
    renderer's call, through kernel and plain (bf16 <= 1e-3, as phase 3)."""
    import os

    from ide3d_tpu_torch.apps import common, gen_videos
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.renderer import RenderParams

    argv = ["--network", snap, *VIDEO_ARGS, "--image-mode", mode, "--output", out]
    # Warm-up (cuDNN heuristics and the allocator at the chunk's shapes), with
    # the first chunk's K1 inputs captured; they are checked and freed before
    # the counted run, so that they do not count in its peak memory.
    captured = []

    def capture_k1(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = capture_k1
    try:
        gen_videos.main(argv)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = captured
    if tuple(args[1].shape) != (VIDEO_CHUNK, 4096, 96, 52) or args[1].dtype != torch.bfloat16:
        raise RuntimeError(f"{label} video: K1 took {args[1].dtype} {tuple(args[1].shape)}")
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    torch.cuda.synchronize()
    _check_finite(f"{label} video K1", got)
    k1_err = max_err(got, ref)
    del got, ref, args, kw, captured
    if k1_err > 1e-3:
        raise RuntimeError(f"{label} video: K1 vs plain at bf16 ({VIDEO_CHUNK}, 4096, 96+96, 52) "
                           f"max abs err {k1_err} > 1e-3")

    written, real = [], common.write_video

    def capture(path, frames, fps=24):
        written.append(frames)
        return real(path, frames, fps)

    common.write_video = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_k1_counts()
        res = gen_videos.main(argv)
        launches = k1_launches("gen_videos")[0]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        common.write_video = real
    (frames,) = written
    if launches != VIDEO_FRAMES // VIDEO_CHUNK:
        raise RuntimeError(f"{label} video: K1 launched {launches} times for "
                           f"{VIDEO_FRAMES // VIDEO_CHUNK} chunks")
    G = common.load_generator(snap, "cuda")
    R = G.cfg.img_resolution
    width = R if mode == "image" else 2 * R
    if len(frames) != VIDEO_FRAMES or any(f.shape != (R, width, 3) or f.dtype != np.uint8
                                          for f in frames):
        raise RuntimeError(f"{label} video: {len(frames)} frames of {frames[0].shape}")
    if not os.path.getsize(res["path"]) > 0:
        raise RuntimeError(f"{label} video: {res['path']} is empty")

    work_ws, work_cs = gen_videos.video_work(G, [0, 1], 1, 1, 2, 8, 1.0, 14, "cuda")
    rp = RenderParams(img_size=G.cfg.render_size, num_steps=96, hierarchical=True)
    with torch.inference_mode():
        o = G.synthesis(torch.as_tensor(work_ws[:VIDEO_CHUNK], device="cuda"),
                        torch.as_tensor(work_cs[:VIDEO_CHUNK], device="cuda"),
                        render_params=rp, return_all=True)
        _check_finite(f"{label} video frames", [o["img"], o["seg"], o["depth"]])
        img8, ex8 = gen_videos.post(o, mode, R)
    ref0 = img8[0] if ex8 is None else torch.cat([img8[0], ex8[0]], dim=1)
    err = int(np.abs(frames[0].astype(np.int32) - ref0.cpu().numpy().astype(np.int32)).max())
    if err > 1:
        raise RuntimeError(f"{label} video: frame 0 vs G.synthesis differs by {err} uint8 levels")
    ms = res["ms_per_frame"]
    print(f"offline: gen_videos {label} ({G.cfg.dtype}, num_ws {G.num_ws}, --image-mode {mode}), "
          f"{VIDEO_FRAMES} frames in chunks of {VIDEO_CHUNK}: {ms:.3f} ms a frame (CUDA events "
          f"around the chunk loop, host pull included), {1e3 / ms:.2f} frames/s, peak "
          f"{peak_gib:.3f} GiB, K1 launches {launches}; frame 0 vs G.synthesis max "
          f"{err} uint8 levels; K1 vs plain on the first chunk's inputs, bf16 ({VIDEO_CHUNK}, "
          f"4096, 96+96, 52), max abs err {k1_err:.3g}; wrote {os.path.basename(res['path'])} "
          f"({smi})", flush=True)
    return {"launches": launches, "ms_per_frame": ms, "fps": 1e3 / ms, "peak_gib": peak_gib,
            "frame0_err": err, "k1_err": k1_err, "frames": np.stack(frames)}


def fp32_copy(G, device: str):
    """G's weights under its config with dtype float32, on `device`."""
    from dataclasses import replace

    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    G32 = Ide3dGenerator(replace(G.cfg, dtype="float32"))
    G32.load_state_dict(G.state_dict())
    return G32.to(device).eval()


def offline_shapes(snap: str, outdir: str, smi: str) -> dict:
    """apps.extract_shapes.main at 256^3 for seed 0 on the snapshot (timed),
    held against the same grid from an fp32 copy of its weights on the card
    (<= 3e-2 x max|sigma|: the bf16 vb stack against fp32); the fp32 copy's
    first 2^18-point chunk is held against the same chunk on the CPU
    (<= 3e-5 x scale)."""
    import os

    from ide3d_tpu_torch.apps import common, extract_shapes as es

    N, M = 256, 2**18
    secs = es.main(["--network", snap, "--seeds", "0", "--voxel-resolution", str(N),
                    "--outdir", outdir, "--device", "cuda"])["seconds_per_seed"][0]
    sig = np.load(os.path.join(outdir, "0.npy")).reshape(-1)
    if sig.size != N**3 or not np.isfinite(sig).all():
        raise RuntimeError(f"extract_shapes: sigma grid of {sig.size} points, finite "
                           f"{np.isfinite(sig).all()}")
    samples = 0.9 * es.create_samples(N, 0.3)
    G = common.load_generator(snap, "cpu")
    grids = {}
    for dev, pts in (("cuda", samples), ("cpu", samples[:M])):
        G32 = fp32_copy(G, dev)
        table = es.fp32_table(G32, es.seed_ws(G32, 0, 1.0, dev))
        grids[dev] = es.sigma_grid(G32.synthesis.renderer, table, pts, M).cpu().numpy()
        del G32, table
    _check_finite("extract_shapes fp32 sigma", [torch.as_tensor(g) for g in grids.values()])
    chunk_err = float(np.abs(grids["cuda"][:M] - grids["cpu"]).max())
    chunk_scale = max(1.0, float(np.abs(grids["cpu"]).max()))
    if chunk_err > 3e-5 * chunk_scale:
        raise RuntimeError(f"extract_shapes: fp32 sigma card vs cpu max abs err {chunk_err}, "
                           f"scale {chunk_scale}")
    bf16_err = float(np.abs(sig - grids["cuda"]).max())
    scale = max(1.0, float(np.abs(grids["cuda"]).max()))
    if bf16_err > 3e-2 * scale:
        raise RuntimeError(f"extract_shapes: bf16 sigma grid vs fp32 max abs err {bf16_err}, "
                           f"scale {scale}")
    print(f"offline: extract_shapes 256^3 sigma of seed 0 (chunks of 2^18 points from the fp32 "
          f"plane table, the snapshot's bf16 vb stack): {secs:.3f} s a seed; range "
          f"[{sig.min():.3f}, {sig.max():.3f}]; the whole grid vs an fp32 copy's on the card max "
          f"abs err {bf16_err:.3g} at scale {scale:.3g} (limit 3e-2 x scale); the fp32 copy's "
          f"first 2^18-point chunk, card vs cpu, max abs err {chunk_err:.3g} at scale "
          f"{chunk_scale:.3g} (limit 3e-5 x scale) ({smi})", flush=True)
    return {"s_per_seed": secs, "sigma_err": chunk_err, "bf16_sigma_err": bf16_err}


def offline_mesh(snap: str, outdir: str, smi: str) -> dict:
    """apps.render_mesh.main at 128^3 with an 8-frame orbit: K1 once a frame
    at S=64+64 (fp32 planes); one frame's K1 inputs through kernel and plain."""
    import os

    from ide3d_tpu_torch.apps import render_mesh
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    video = os.path.join(outdir, "orbit.mp4")
    renderer.sort_integrate = capture
    try:
        zero_k1_counts()
        res = render_mesh.main(["--network", snap, "--voxel-resolution", "128", "--video", video,
                                "--frames", str(MESH_FRAMES), "--outdir", outdir, "--device", "cuda"])
        launches = k1_launches("render_mesh")[0]
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    if launches != MESH_FRAMES:
        raise RuntimeError(f"render_mesh: K1 launched {launches} times for {MESH_FRAMES} frames")
    for name in ("0.obj", "0.ply"):
        if not os.path.getsize(os.path.join(outdir, name)) > 0:
            raise RuntimeError(f"render_mesh: {name} is empty")
    if not res["faces"] > 0 or not os.path.getsize(res["video"]) > 0:
        raise RuntimeError(f"render_mesh: {res['faces']} faces, video {res['video']}")
    ((args, kw),) = captured
    if tuple(args[1].shape) != (1, 4096, 64, 52) or tuple(args[3].shape) != (1, 4096, 64, 52) \
            or args[1].dtype != torch.float32:
        raise RuntimeError(f"render_mesh: K1 took {args[1].dtype} {tuple(args[1].shape)} + "
                           f"{tuple(args[3].shape)}")
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    torch.cuda.synchronize()
    _check_finite("render_mesh K1", got)
    err = max_err(got, ref)
    if err > 1e-4:
        raise RuntimeError(f"render_mesh: K1 vs plain at S=64+64 fp32 max abs err {err} > 1e-4")
    ms = res["ms_per_frame"]
    print(f"offline: render_mesh 128^3, iso level {res['level']:.3f}, {res['verts']} verts, "
          f"{res['faces']} faces; {MESH_FRAMES}-frame orbit of shaded depth at 64+64 samples: "
          f"{ms:.3f} ms a frame (host clock, shading and depth pull included), K1 launches "
          f"{launches}, K1 vs plain at fp32 (1, 4096, 64+64, 52) max abs err {err:.3g} ({smi})",
          flush=True)
    return {"launches": launches, "ms_per_frame": ms, "k1_err": err}


def phase_offline(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    with tempfile.TemporaryDirectory() as root:
        flagship, refc = os.path.join(root, "flagship"), os.path.join(root, "ref_compat")
        t0 = time.perf_counter()
        write_snapshot(flagship, GeneratorConfig(), seed=0)
        write_snapshot(refc, GeneratorConfig(vb_ref_compat=True, raw_head="slice"), seed=1)
        snap_s = time.perf_counter() - t0
        v_flag = offline_video(flagship, "image_seg", os.path.join(root, "flagship.mp4"), smi,
                               "flagship snapshot")
        v_refc = offline_video(refc, "image_depth", os.path.join(root, "ref_compat.mp4"), smi,
                               "reference-compat")
        fp32 = fp32_card_vs_cpu(GeneratorConfig(vb_ref_compat=True, raw_head="slice",
                                                dtype="float32"), 1, "reference-compat")
        print(f"offline: GeneratorConfig(vb_ref_compat=True, raw_head=slice, dtype=float32) batch "
              f"1, cuda (K1) vs cpu (plain): max abs err {fp32['err']} at output scale "
              f"{fp32['scale']} (limit 3e-5 x scale); two snapshots written in {snap_s:.1f} s "
              f"({smi})", flush=True)
        shapes = offline_shapes(flagship, os.path.join(root, "shapes"), smi)
        mesh = offline_mesh(flagship, os.path.join(root, "mesh"), smi)
    return {"video": {"flagship": v_flag, "ref_compat": v_refc}, "fp32": fp32, "shapes": shapes,
            "mesh": mesh}


# Phase 9's runs of apps.calc_metrics: (metrics, detector, --num-items, K1 launches).
# Every G pass launches K1 once: FID/KID/PR/IS each extract num_items images at
# batch 8, PPL renders a pair per item (batch 8), EQ-T and EQ-R two batch-1
# renders per item.
METRIC_RUNS = (
    ("fid,kid,pr,is", "inception", 256, {"fid": 32, "kid": 32, "pr": 32, "is": 32}),
    ("ppl2_wend", "vgg16", 64, {"ppl2_wend": 16}),
    ("eqt,eqr", "pixel", 8, {"eqt": 16, "eqr": 16}),
)
METRIC_BATCH = 8
METRIC_IMAGES = 64  # the labelled 512² dataset's size


def metrics_counted(snap: str, imgs: str, root: str, smi: str) -> dict:
    """apps.calc_metrics.main on the snapshot at --batch 8, once per METRIC_RUNS
    entry, with per metric: its record, K1 launches, wall time, the generator
    extraction's images/s, peak memory. K1's inputs of the first B=8 call and
    of the second B=1 call (EQ-T renders rp0, then rp1 with the pixel offset)
    are kept and held against the plain version (bf16 <= 1e-3, as phase 3)."""
    import os

    import ide3d_tpu_torch.metrics as M
    from ide3d_tpu_torch.apps import calc_metrics
    from ide3d_tpu_torch.metrics import frechet_inception_distance, inception_score, \
        kernel_inception_distance, precision_recall
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    kept, calls = {}, {}

    def capture(*args, **kw):
        B = args[1].shape[0]
        calls[B] = calls.get(B, 0) + 1
        if (B, calls[B]) in ((METRIC_BATCH, 1), (1, 2)):
            kept[B] = (args, kw)
        return ray_march.sort_integrate(*args, **kw)

    per, gen_s = {}, []
    real_calc = M.calc_metric

    def counted_calc(name, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen_s.clear()
        zero_k1_counts()
        rec = real_calc(name, **kw)
        torch.cuda.synchronize()
        per[name] = {"rec": rec, "launches": k1_launches(f"calc_metric {name}")[0],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "gen_s": sum(gen_s)}
        return rec

    gen_mods = (frechet_inception_distance, kernel_inception_distance, precision_recall,
                inception_score)
    real_gen = M.metric_utils.compute_feature_stats_for_generator

    def timed_gen(*args, **kw):
        t0 = time.perf_counter()
        st = real_gen(*args, **kw)  # its loop reads each batch's features to the host
        gen_s.append(time.perf_counter() - t0)
        return st

    renderer.sort_integrate = capture
    M.calc_metric = counted_calc
    for m in gen_mods:
        m.compute_feature_stats_for_generator = timed_gen
    try:
        # PyTorch's default precision, as a calc_metrics process runs: cuDNN TF32
        # on (phase 1 turns it off for the rest of the script).
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            for metrics, det, n, _ in METRIC_RUNS:
                calc_metrics.main(["--network", snap, "--data", imgs, "--metrics", metrics,
                                   "--detector", det, "--num-items", str(n), "--batch",
                                   str(METRIC_BATCH), "--device", "cuda",
                                   "--cache-dir", os.path.join(root, "cache"),
                                   "--run-dir", os.path.join(root, "metrics")])
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
        M.calc_metric = real_calc
        for m in gen_mods:
            m.compute_feature_stats_for_generator = real_gen

    for metrics, det, n, launches in METRIC_RUNS:
        for name, want in launches.items():
            got = per[name]
            vals = got["rec"]["results"]
            if not all(np.isfinite(v) for v in vals.values()):
                raise RuntimeError(f"metrics: {name} gave {vals}")
            if got["launches"] != want:
                raise RuntimeError(f"metrics: {name} launched K1 {got['launches']} times, want {want}")
            images = {"ppl2_wend": 2 * n, "eqt": 2 * n, "eqr": 2 * n}.get(name, n)
            secs = got["gen_s"] or got["rec"]["total_time"]
            got["imgs_per_s"] = images / secs
            print(f"metrics: {name} = {json.dumps(vals)} (detector {det}, "
                  f"{got['rec']['detector']['source']}; --num-items {n}, batch {METRIC_BATCH}, "
                  f"flagship bf16 G at 512²): total_time {got['rec']['total_time']:.3f} s; "
                  f"{images} G images at {got['imgs_per_s']:.2f} images/s "
                  f"({'generator extraction, G + detector' if got['gen_s'] else 'the whole metric'}"
                  f", host clock); K1 launches {got['launches']}; peak {got['peak_gib']:.3f} GiB "
                  f"({smi})", flush=True)

    errs = {}
    for B, label in ((METRIC_BATCH, "B=8"), (1, "B=1 with pixel_offset")):
        args, kw = kept[B]
        if tuple(args[1].shape) != (B, 4096, 96, 52) or args[1].dtype != torch.bfloat16:
            raise RuntimeError(f"metrics: K1 took {args[1].dtype} {tuple(args[1].shape)}")
        with torch.inference_mode():
            got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
        torch.cuda.synchronize()
        _check_finite(f"metrics K1 {label}", got)
        errs[label] = max_err(got, ref)
        if errs[label] > 1e-3:
            raise RuntimeError(f"metrics: K1 vs plain at bf16 {label} max abs err {errs[label]} > 1e-3")
    kept.clear()
    print(f"metrics: K1 vs plain on the metrics' own inputs, bf16 (B, 4096, 96+96, 52): max abs "
          f"err {errs} (limit 1e-3)", flush=True)
    return {"per": {k: {kk: v[kk] for kk in ("launches", "peak_gib", "imgs_per_s")} |
                    {"total_time": v["rec"]["total_time"], "results": v["rec"]["results"]}
                    for k, v in per.items()},
            "k1_err": errs}


# fp32 copy of the flagship, card against CPU: Inception features relative to
# max|feature| with TF32 off and with cuDNN TF32 on (PyTorch's default, the
# precision calc_metrics runs at); for PPL on deterministic renders, the VGG16
# features relative to max|feature| and the pair distances relative to each
# distance (see metrics_fp32). Readings on an H100 80GB HBM3 at 700 W: 2.05e-6,
# 9.6e-4, 3.72e-6 and 1.07e-2 (the random renders' distances 2.92e-2).
FEAT_TOL, FEAT_TF32_TOL, VGG_TOL, PPL_TOL = 1e-5, 5e-3, 2e-5, 2e-2


def fixed_pair_features(G, det, z0, z1, c, epsilon: float = 1e-4) -> tuple:
    """The detector features of ppl2_wend's two renders of a pair (w space,
    t = 0, no crop), rendered deterministically: noise 'const' and no
    generator, so two devices render one function."""
    from ide3d_tpu_torch.metrics.perceptual_path_length import _crop_and_downsample

    ws0, ws1 = G.mapping(z0, c), G.mapping(z1, c)
    return tuple(det(_crop_and_downsample(G.synthesis(ws0 + (ws1 - ws0) * s, c).float(), False))
                 .float().cpu().numpy() for s in (0.0, epsilon))


def metrics_fp32(snap: str, imgs: str, smi: str) -> dict:
    """An fp32 copy of the snapshot's G, card against CPU, on the metrics' own
    first batch (z, c from RandomState(0) as the metric draws them):
      * its Inception features through compute_feature_stats_for_generator,
        with TF32 off (FEAT_TOL x max|feature|) and on the card once more with
        cuDNN TF32 on for G and the detector (FEAT_TF32_TOL);
      * for PPL, on the deterministic renders of a pair: the VGG16 features
        (VGG_TOL x max|feature|) and the pair distances (PPL_TOL relative;
        1/epsilon² turns the renders' rounding into ~1e-2). PPL's own random
        renders draw the depth jitter and the importance samples from each
        device's torch.Generator stream (CPU and CUDA streams differ for one
        seed): those distances are printed, with the bf16 G's on the card on
        the fp32 copy's draws, and not held."""
    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.data.dataset import ImageFolderDataset
    from ide3d_tpu_torch.metrics import make_detector
    from ide3d_tpu_torch.metrics.metric_utils import MetricOptions, \
        compute_feature_stats_for_generator, sample_labels
    from ide3d_tpu_torch.metrics.perceptual_path_length import pair_distances

    B = METRIC_BATCH
    G = common.load_generator(snap, "cpu")
    ds = ImageFolderDataset(imgs, resolution=G.cfg.img_resolution)
    rs = np.random.RandomState(0)
    z0, z1 = rs.randn(B, G.cfg.z_dim), rs.randn(B, G.cfg.z_dim)
    c = sample_labels(MetricOptions(dataset=ds), rs, B)
    feats, vgg, drawn = {}, {}, {}
    for dev in ("cuda", "cpu"):
        G32 = fp32_copy(G, dev)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        opts = MetricOptions(G=G32, dataset=ds, detector=make_detector("inception", device=dev),
                             num_items=B, batch_size=B, device=dev)
        feats[dev] = compute_feature_stats_for_generator(opts, capture_all=True,
                                                         capture_mean_cov=False).get_all()
        if dev == "cuda":
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                feats["cuda_tf32"] = compute_feature_stats_for_generator(
                    opts, capture_all=True, capture_mean_cov=False).get_all()
        opts = MetricOptions(G=G32, detector=make_detector("vgg16", device=dev), device=dev)
        with torch.inference_mode():
            vgg[dev] = fixed_pair_features(G32, opts.detector, t(z0), t(z1), t(c))
            drawn[dev] = pair_distances(opts, t(z0), t(z1), t(c), t(np.zeros(B)), 0).cpu().numpy()
            if dev == "cuda":
                opts.G = G.to(dev)
                bf16 = pair_distances(opts, t(z0), t(z1), t(c), t(np.zeros(B)), 0).cpu().numpy()
                G.cpu()
        del G32, opts
    for name, v in (("features", feats), ("vgg", vgg), ("drawn ppl", drawn)):
        for dev, a in v.items():
            if not np.isfinite(a).all():
                raise RuntimeError(f"metrics fp32: non-finite {name} on {dev}")
    scale = np.abs(feats["cpu"]).max()
    feat_err = float(np.abs(feats["cuda"] - feats["cpu"]).max() / scale)
    feat_tf32_err = float(np.abs(feats["cuda_tf32"] - feats["cpu"]).max() / scale)
    vgg_err = float(max(np.abs(a - b).max() / np.abs(b).max()
                        for a, b in zip(vgg["cuda"], vgg["cpu"])))
    fixed = {dev: ((f0 - f1) ** 2).sum(axis=-1) / 1e-4**2 for dev, (f0, f1) in vgg.items()}
    ppl_err = float((np.abs(fixed["cuda"] - fixed["cpu"]) / fixed["cpu"]).max())
    drawn_err = float((np.abs(drawn["cuda"] - drawn["cpu"]) / drawn["cpu"]).max())
    print(f"metrics: fp32 copy of the flagship, cuda vs cpu, first batch of {B} (matmul TF32 "
          f"off): Inception features max abs err / max|feature| {feat_err:.3g} with TF32 off "
          f"(limit {FEAT_TOL:g}), {feat_tf32_err:.3g} with cuDNN TF32 on for G and Inception "
          f"(limit {FEAT_TF32_TOL:g}; max|feature| {scale:.4g}); PPL on deterministic renders: "
          f"VGG16 features max abs err / max|feature| {vgg_err:.3g} (limit {VGG_TOL:g}), pair "
          f"distances cuda {np.round(fixed['cuda'], 1).tolist()}, cpu "
          f"{np.round(fixed['cpu'], 1).tolist()}, max relative err {ppl_err:.3g} (limit "
          f"{PPL_TOL:g}); of PPL's random renders (each device's own draws, not held) max "
          f"relative err {drawn_err:.3g}; the bf16 G's distances on the card, on the fp32 "
          f"copy's draws there: {np.round(bf16, 1).tolist()} ({smi})", flush=True)
    if (feat_err > FEAT_TOL or feat_tf32_err > FEAT_TF32_TOL or vgg_err > VGG_TOL
            or ppl_err > PPL_TOL):
        raise RuntimeError(f"metrics fp32 cuda vs cpu: features {feat_err} (limit {FEAT_TOL}), "
                           f"with TF32 {feat_tf32_err} (limit {FEAT_TF32_TOL}), vgg {vgg_err} "
                           f"(limit {VGG_TOL}), ppl {ppl_err} (limit {PPL_TOL})")
    return {"feat_err": feat_err, "feat_tf32_err": feat_tf32_err, "vgg_err": vgg_err,
            "ppl_err": ppl_err,
            "ppl_drawn_err": drawn_err, "ppl_fp32": drawn["cuda"].tolist(),
            "ppl_bf16": bf16.tolist()}


def phase_metrics(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        write_snapshot(snap, GeneratorConfig(), seed=0)
        imgs, _ = write_dataset(root, METRIC_IMAGES, 512)
        counted = metrics_counted(snap, imgs, root, smi)
        fp32 = metrics_fp32(snap, imgs, smi)
    return {"counted": counted, "fp32": fp32}


# Phase 10: inversion at the flagship width. K1 (forward, backward) launches:
# a projector step renders once and differentiates once; a PTI step likewise,
# + the mirrored view (1, 1) with --join-view, + the locality term's tuned
# render (1, 1) and the frozen G's render (1, 0) with --use-locality; _save_viz
# renders the pivot once (+ 60 orbit frames with --video); an encoder step
# renders the synthetic target without a gradient (1, 0), its reconstruction
# (1, 1) and the real batch's reconstruction (1, 1).
INV_TARGETS = 2
INV_PROJ_STEPS, INV_PTI_STEPS, INV_JV_PTI_STEPS = 10, 10, 4
INV_LAUNCHES = {"projector": (1, 1), "pti": (1, 1), "pti_jv_loc": (4, 3), "viz": (1, 0),
                "viz_video": (61, 0), "encoder": (3, 2)}
ENC_STEPS, ENC_BATCH = 3, 4
INV_RES = 512  # the flagship's output, the targets' and the datasets' size
# Card against CPU, fp32, each gradient to 1e-4 x max|grad|, and every fp32 run
# against the CPU in float64 likewise, but for one: the w+ gradient of the card
# with cuDNN's convolutions, held to 2e-3. Its rows 0-2 (the 4² block's
# styles) read 4.59e-4 against the CPU in fp32 and in float64 alike, while the
# CPU's fp32 reads 3.2e-6 against float64 and the card with PyTorch's own CUDA
# convolutions 4.2e-5: the card's cuDNN fp32 convolutions carry the gap, each
# within 4.3e-6 of max of the same convolution on the CPU
# (tools/check_inversion_grads.py; H100 80GB HBM3, 700 W; PERF.md, open
# questions).
INV_GRAD_TOL, INV_W_TOL, FACE_TOL = 1e-4, 2e-3, 1e-5


class StepMeter:
    """K1's forward and backward launches and a CUDA event at every Adam step
    (the projector, PTI and the encoder trainer take one a loop iteration) and
    at every other mark, under the label of the loop in progress; the counts
    restart at each mark."""

    def __init__(self):
        self.records, self.label = [], None
        self.mse, self.peak = [], {}
        zero_k1_counts()

    def mark(self, label) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.records.append((label, *k1_launches(f"{label} record"), ev))
        zero_k1_counts()

    def launches(self, label) -> list:
        return [(f, b) for lab, f, b, _ in self.records if lab == label]

    def step_ms(self, label) -> list:
        """Event ms of each step after the first of its loop (the first one's
        interval holds the loop's set-up)."""
        torch.cuda.synchronize()
        return [e1.elapsed_time(e2) for (l1, _, _, e1), (l2, _, _, e2)
                in zip(self.records, self.records[1:]) if l1 == l2 == label]

    def check(self, want: dict, name: str) -> None:
        """Every record of a label in `want` has exactly its launches; marks
        between the loops launch nothing."""
        for lab, f, b, _ in self.records:
            if lab in want and (f, b) != want[lab]:
                raise RuntimeError(f"{name}: K1 (forward, backward) launches {(f, b)} at a {lab} "
                                   f"record, want {want[lab]}")
            if lab == "between" and (f, b) != (0, 0):
                raise RuntimeError(f"{name}: K1 launched {(f, b)} outside the inversion loops")


def _metered(meter: StepMeter, pti_label: str = "pti", viz_label: str = "viz"):
    """Patches Adam.step, train.pti.project_w_plus / pivotal_tune and
    run_pti._save_viz (run_pti imports them at the call) so that `meter`
    labels each loop's steps; around each loop the reconstruction MSE of its
    start and its result (renders labelled "extra") and its peak memory.
    Until the restore function it returns is called, cuDNN runs at PyTorch's
    default precision, TF32 on, as a user's process does (phase 1 turns it
    off for the rest of the script)."""
    from ide3d_tpu_torch.apps import run_pti
    from ide3d_tpu_torch.train import pti

    real = (torch.optim.Adam.step, pti.project_w_plus, pti.pivotal_tune, run_pti._save_viz)

    def mse(G, w, c, target):
        with torch.no_grad():
            return float((G.synthesis(w, c).float() - target).square().mean())

    def loop(label, fn, *a, **kw):
        meter.mark("between")
        torch.cuda.reset_peak_memory_stats()
        meter.label = label
        try:
            return fn(*a, **kw)
        finally:
            meter.label = None
            torch.cuda.synchronize()
            meter.peak[label] = max(meter.peak.get(label, 0.0),
                                    torch.cuda.max_memory_allocated() / 2**30)

    def step(opt, *a, **kw):
        out = real[0](opt, *a, **kw)
        if meter.label is not None:
            meter.mark(meter.label)
        return out

    def project(G, target, c, cfg, initial_w=None, generator=None, **kw):
        state = generator.get_state()
        w, noise = loop("projector", real[1], G, target, c, cfg, initial_w=initial_w,
                        generator=generator, **kw)
        g = torch.Generator(device=target.device)
        g.set_state(state)
        w0 = initial_w
        if w0 is None:
            w_avg, _ = pti.compute_w_stats(G, c, cfg.w_avg_samples, g)
            w0 = w_avg[:, None].repeat(1, G.num_ws, 1)
        meter.mse.append(("projector", mse(G, w0, c, target),
                          mse(run_pti._with_noise(G, noise), w, c, target)))
        meter.mark("extra")
        return w, noise

    def tune(G, w, target, c, cfg, *a, **kw):
        before = mse(G, w, c, target)
        meter.mark("extra")
        tuned = loop(pti_label, real[2], G, w, target, c, cfg, *a, **kw)
        meter.mse.append((pti_label, before, mse(tuned, w, c, target)))
        meter.mark("extra")
        return tuned

    def viz(*a, **kw):
        meter.mark("between")
        out = real[3](*a, **kw)
        meter.mark(viz_label)
        return out

    torch.optim.Adam.step, pti.project_w_plus, pti.pivotal_tune, run_pti._save_viz = \
        step, project, tune, viz
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True

    def restore():
        torch.optim.Adam.step, pti.project_w_plus, pti.pivotal_tune, run_pti._save_viz = real
        torch.backends.cudnn.allow_tf32 = tf32

    return restore


def write_targets(G, root: str, n: int) -> tuple:
    """n targets: G's render at a known w (seed i) plus an offset (0.3 N(0, 1)),
    at the front camera, as 512² PNGs; their seg argmax as mask PNGs."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps.common import save_image_grid
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    imgs, masks = os.path.join(root, "targets"), os.path.join(root, "target_masks")
    os.makedirs(imgs)
    os.makedirs(masks)
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    for i in range(n):
        rs = np.random.RandomState(100 + i)
        with torch.no_grad():
            w = G.mapping(torch.as_tensor(rs.randn(1, G.z_dim), dtype=torch.float32, device="cuda"), c)
            w = w + 0.3 * torch.as_tensor(rs.randn(1, G.num_ws, G.w_dim), dtype=torch.float32,
                                          device="cuda")
            img, seg = G.synthesis(w, c, return_seg=True)
        save_image_grid(img.float().cpu().numpy(), os.path.join(imgs, f"t{i}.png"))
        PIL.Image.fromarray(seg[0].argmax(-1).to(torch.uint8).cpu().numpy()).save(
            os.path.join(masks, f"t{i}.png"))
    return imgs, masks


def _check_reload(outdir: str, name: str) -> float:
    """model_<name> through load_generator renders the pivot within 1 uint8
    level of <name>_compare.png's reconstruction. Returns the largest level gap."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import common

    G = common.load_generator(os.path.join(outdir, f"model_{name}"), "cuda")
    ws = torch.as_tensor(np.load(os.path.join(outdir, f"{name}.npz"))["ws"], device="cuda")
    c = torch.as_tensor(np.load(os.path.join(outdir, f"{name}_label.npz"))["c"], device="cuda")
    # at the precision run_pti rendered the compare image with (_metered)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        img = G.synthesis(ws, c, noise_mode="const")[0].float().cpu().numpy()
    want = np.rint((img + 1) * 127.5).clip(0, 255)
    pair = np.asarray(PIL.Image.open(os.path.join(outdir, f"{name}_compare.png")), np.float32)
    R = img.shape[0]
    gap = float(np.abs(pair[:, R:] - want).max())
    if gap > 1:
        raise RuntimeError(f"run_pti: model_{name} renders {gap} uint8 levels off its compare image")
    return gap


def inversion_pti(snap: str, imgs: str, root: str, smi: str) -> dict:
    """apps.run_pti.main: 2 targets at 10 + 10 steps; 1 with --join-view
    --use-locality --video (2 + 4); 1 from e4e pivots (2 + 2). Launches per
    step and per _save_viz, MSE falling in both loops, the snapshots' reload,
    event ms per step, peaks; K1's inputs and cotangents of a projector step."""
    import os

    from ide3d_tpu_torch.apps import run_pti
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    captured = {}
    meter = StepMeter()

    def capture(*args, **kw):
        out = ray_march.sort_integrate(*args, **kw)
        if not captured and meter.label == "projector" and args[1].requires_grad:
            captured["args"] = tuple(a.detach() for a in args)
            captured["kw"] = kw
            captured["cot"] = [None, None, None]
            for i, t in enumerate(out):
                if t.requires_grad:
                    # an output the step does not use gets None (zeros below)
                    t.register_hook(lambda g, i=i: captured["cot"].__setitem__(
                        i, None if g is None else g.detach()))
        return out

    base = ["--network", snap, "--lpips-threshold", "0", "--device", "cuda"]
    e4e = os.path.join(root, "e4e.pt")
    e4e_model = write_e4e(e4e)
    restore = _metered(meter)
    renderer.sort_integrate = capture
    try:
        t0 = time.perf_counter()
        run_pti.main(base + ["--images", imgs, "--outdir", os.path.join(root, "pti"),
                             "--projector-steps", str(INV_PROJ_STEPS), "--pti-steps",
                             str(INV_PTI_STEPS)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        meter.mark("between")
    finally:
        restore()
        renderer.sort_integrate = ray_march.sort_integrate
    meter.check({k: INV_LAUNCHES[k] for k in ("projector", "pti", "viz")}, "run_pti")
    main = {"launches": {k: meter.launches(k) for k in ("projector", "pti", "viz")},
            "ms": {k: meter.step_ms(k) for k in ("projector", "pti")}, "mse": meter.mse,
            "peak_gib": meter.peak, "run_s": main_s}
    if len(main["launches"]["projector"]) != INV_TARGETS * INV_PROJ_STEPS \
            or len(main["launches"]["pti"]) != INV_TARGETS * INV_PTI_STEPS \
            or len(main["launches"]["viz"]) != INV_TARGETS:
        raise RuntimeError(f"run_pti: steps counted {[(k, len(v)) for k, v in main['launches'].items()]}")
    for label, before, after in meter.mse:
        if not (np.isfinite(after) and after < before):
            raise RuntimeError(f"run_pti: the {label} loop's reconstruction MSE {before} -> {after}")
    names = [os.path.splitext(f)[0] for f in sorted(os.listdir(imgs))]
    main["reload_gap"] = max(_check_reload(os.path.join(root, "pti"), n) for n in names)

    jv = StepMeter()
    restore = _metered(jv, pti_label="pti_jv_loc", viz_label="viz_video")
    try:
        run_pti.main(base + ["--images", os.path.join(imgs, f"{names[0]}.png"), "--outdir",
                             os.path.join(root, "pti_jv"), "--projector-steps", "2", "--pti-steps",
                             str(INV_JV_PTI_STEPS), "--join-view", "--use-locality", "--video"])
        jv.mark("between")
    finally:
        restore()
    jv.check({k: INV_LAUNCHES[k] for k in ("projector", "pti_jv_loc", "viz_video")},
             "run_pti --join-view --use-locality --video")
    files = os.listdir(os.path.join(root, "pti_jv"))
    if not any(f.startswith(f"{names[0]}_orbit.") for f in files):
        raise RuntimeError(f"run_pti --video wrote {files}")
    join = {"launches": {k: jv.launches(k) for k in ("projector", "pti_jv_loc", "viz_video")},
            "ms": jv.step_ms("pti_jv_loc"), "peak_gib": jv.peak.get("pti_jv_loc"), "mse": jv.mse}

    em = StepMeter()
    restore = _metered(em)
    try:
        run_pti.main(base + ["--images", os.path.join(imgs, f"{names[0]}.png"), "--outdir",
                             os.path.join(root, "pti_e4e"), "--projector-steps", "2",
                             "--pti-steps", "2", "--e4e", e4e])
        em.mark("between")
    finally:
        restore()
    em.check({k: INV_LAUNCHES[k] for k in ("projector", "pti", "viz")}, "run_pti --e4e")
    start = torch.as_tensor(np.load(os.path.join(root, "pti_e4e", f"{names[0]}.npz"))["ws"])
    if not torch.isfinite(start).all():
        raise RuntimeError("run_pti --e4e: non-finite pivot")

    # K1 on a projector step's own inputs and cotangents, kernel against plain.
    args, kw = captured["args"], captured["kw"]
    B, Rr, _, c1 = args[1].shape
    cot = [torch.zeros(B, Rr, n, device="cuda") if g is None else g.float().contiguous()
           for g, n in zip(captured["cot"], (c1 - 1, 1, 1))]
    with torch.no_grad():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
        fwd_err = max_err(got, ref)
        gb = ray_march.sort_integrate_backward(*args, *cot, **kw)
        rb = ray_march.sort_integrate_backward_plain(*args, *cot, **kw)
    torch.cuda.synchronize()
    _check_finite("inversion K1", [*got, *gb])
    bwd_err = rel_err(gb, rb)
    if fwd_err > 1e-3 or bwd_err > 1e-2:
        raise RuntimeError(f"inversion: K1 vs plain on a projector step's inputs {fwd_err} (limit "
                           f"1e-3), backward / max|grad| {bwd_err} (limit 1e-2)")
    k1 = {"fwd_err": fwd_err, "bwd_err": bwd_err, "dtype": str(args[1].dtype),
          "shape": [list(args[1].shape), list(args[3].shape)],
          "cot_max": [float(g.abs().max()) for g in cot]}
    med = {k: statistics.median(v) for k, v in main["ms"].items()}
    med["pti_jv_loc"] = statistics.median(join["ms"])
    print(f"inversion: apps.run_pti.main, GeneratorConfig() bf16 snapshot, {INV_TARGETS} targets "
          f"(512², G's render at a known w + 0.3 N(0,1)), {INV_PROJ_STEPS} projector + "
          f"{INV_PTI_STEPS} PTI steps, --lpips-threshold 0 ({smi}): event ms per step median "
          f"projector {med['projector']:.3f}, PTI {med['pti']:.3f} (each {[round(t, 3) for t in main['ms']['projector']]}, "
          f"{[round(t, 3) for t in main['ms']['pti']]}); peak GiB {json.dumps({k: round(v, 3) for k, v in main['peak_gib'].items()})}; "
          f"K1 (forward, backward) per projector step {sorted(set(main['launches']['projector']))}, "
          f"per PTI step {sorted(set(main['launches']['pti']))}, per _save_viz "
          f"{sorted(set(main['launches']['viz']))}; reconstruction MSE (start, end) "
          f"{[(lab, round(a, 5), round(b, 5)) for lab, a, b in main['mse']]}; model_<name> "
          f"reloaded by load_generator within {main['reload_gap']:.0f} uint8 level of _compare.png; "
          f"wall {main_s:.1f} s", flush=True)
    print(f"inversion: --join-view --use-locality --video (2 + {INV_JV_PTI_STEPS} steps): PTI step "
          f"{med['pti_jv_loc']:.3f} ms median, peak {join['peak_gib']:.3f} GiB, K1 per PTI step "
          f"{sorted(set(join['launches']['pti_jv_loc']))}, per _save_viz with the 60-frame orbit "
          f"{join['launches']['viz_video']}; MSE {[(lab, round(a, 5), round(b, 5)) for lab, a, b in join['mse']]}; "
          f"--e4e (E4eEncoder(1024) random init, pSp layout, opts.encoder_type): K1 as the plain "
          f"run, {em.launches('projector')} / {em.launches('pti')} / {em.launches('viz')}; K1 on a "
          f"projector step's captured inputs ({k1['dtype']} {k1['shape']}) vs plain max abs err "
          f"{fwd_err:.3g} (limit 1e-3), its backward on the step's own cotangents (max "
          f"{[round(v, 6) for v in k1['cot_max']]}) vs autograd through plain, max abs err / "
          f"max|grad| {bwd_err:.3g} (limit 1e-2)", flush=True)
    return {"main": main, "join": join, "k1": k1, "median_ms": med, "e4e_model": e4e_model,
            "names": names}


def write_e4e(path: str):
    """E4eEncoder(1024, 'e4e') (18 rows, as the flagship's w+) with random
    weights drawn on the card (convs N(0, 0.025²), EqualLinear N(0, 1), identity
    BN, PReLU 0.25), saved in fp16 in the pSp layout with its latent_avg and
    an opts Namespace naming Encoder4Editing. Returns the model (fp32, card)."""
    import argparse

    from ide3d_tpu_torch.models.arcface import reset_norms
    from ide3d_tpu_torch.models.e4e import E4eEncoder

    model = E4eEncoder(1024, "e4e").cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.025)
            elif name.endswith("linear.weight"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda"))
            elif name.endswith("bias"):
                p.zero_()
        reset_norms(model)
    sd = {f"encoder.{k}": v.half().cpu() for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd, "latent_avg": torch.linspace(-0.5, 0.5, 512),
                "opts": argparse.Namespace(encoder_type="Encoder4Editing")}, path)
    with torch.no_grad():  # the weights as the file holds them
        for k, v in model.state_dict().items():
            v.copy_(sd[f"encoder.{k}"].float())
    return model


@contextlib.contextmanager
def float64_render():
    """Inside, an fp32 copy of G made here computes in float64 on the CPU from
    end to end: the "float32" compute dtype maps to float64, and the port's
    casts to float32 (`.float()`, the FIR filters' `as_tensor`, the rays'
    default dtype) keep float64. The third witness of the fp32 card-against-CPU
    gradients."""
    from ide3d_tpu_torch.models import blocks

    real = (blocks.DTYPES["float32"], torch.Tensor.float, torch.as_tensor, torch.get_default_dtype())

    def keep64(t, *a, **kw):
        return t if t.dtype == torch.float64 else real[1](t, *a, **kw)

    def as_tensor(data, dtype=None, device=None):
        if dtype == torch.float32 and isinstance(data, torch.Tensor) and data.dtype == torch.float64:
            dtype = torch.float64
        return real[2](data, dtype=dtype, device=device)

    blocks.DTYPES["float32"], torch.Tensor.float, torch.as_tensor = torch.float64, keep64, as_tensor
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        blocks.DTYPES["float32"], torch.Tensor.float, torch.as_tensor = real[:3]
        torch.set_default_dtype(real[3])


def inversion_grads(G, target, c, runs, strength: float = 0.1) -> dict:
    """One projector step's gradients in w+ and the noise buffers, and one PTI
    step's in the tuned synthesis parameters, of copies of G (noise strengths
    `strength`) on the same inputs, for each (label, device, dtype, context)
    of `runs` (TF32 off; the context, e.g. float64_render, is entered around
    the run). The first run records its importance depths (detached) and the
    others replay them, so that all differentiate one function. Returns
    {label: {"w" | "noise" | "pti": [float64 CPU tensors]}}."""
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.train import pti

    rs = np.random.RandomState(7)
    out, depths = {}, []
    real_pdf = renderer.sample_pdf

    def recorded(*a, **kw):
        depths.append(real_pdf(*a, **kw))
        return depths[-1]

    def replayed(*a, **kw):
        return depths[replayed.i].to(a[0].device, a[0].dtype)

    try:
        for i, (label, dev, dtype, context) in enumerate(runs):
            renderer.sample_pdf = replayed if i else recorded
            replayed.i = 0
            with context():
                Gx = fp32_copy(G, dev).to(dtype)
                with torch.no_grad():
                    for name, p in Gx.named_parameters():
                        if name.endswith("noise_strength"):
                            p.fill_(strength)
                if not i:
                    w0 = (Gx.mapping.w_avg[None, None].repeat(1, Gx.num_ws, 1).double()
                          + torch.as_tensor(rs.randn(1, Gx.num_ws, Gx.w_dim) * 0.3))
                    shapes = dict(Gx.synthesis.named_parameters())
                    noise0 = {k: torch.as_tensor(rs.randn(*shapes[k].shape))
                              for k in pti.noise_buffer_paths(Gx.synthesis)}
                w = w0.to(dev, dtype).requires_grad_(True)
                noise = {k: v.to(dev, dtype).requires_grad_(True) for k, v in noise0.items()}
                tgt, cc = target.to(dev, dtype), c.to(dev, dtype)
                with torch.enable_grad():
                    feats = [f.detach() for f in pti.default_pyramid_feats(tgt)]
                    loss, _ = pti.projector_loss(Gx, w, noise, cc, feats, pti.ProjectorConfig())
                    gp = torch.autograd.grad(loss, [w, *noise.values()])
                    replayed.i = 1
                    params = pti.trainable_synthesis_params(Gx)
                    loss2, _ = pti.pti_loss(Gx, Gx, w.detach(), tgt, cc, pti.PtiConfig(),
                                            pti.pyramid_distance)
                    gt = torch.autograd.grad(loss2, params)
                out[label] = {k: [g.detach().double().cpu() for g in v]
                              for k, v in (("w", gp[:1]), ("noise", gp[1:]), ("pti", gt))}
                for k, v in out[label].items():
                    _check_finite(f"inversion grads {label} {k}", v)
                del Gx
    finally:
        renderer.sample_pdf = real_pdf
    if len(depths) != 2:
        raise RuntimeError(f"inversion: {len(depths)} importance draws recorded, want 2")
    return out


def grad_gap(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| in float64 for each gradient, and the w+
    gradient's by row of w+."""
    gap = {k: max(float((g - r).abs().max()) for g, r in zip(got[k], ref[k]))
           / max(float(r.abs().max()) for r in ref[k]) for k in ("w", "noise", "pti")}
    rows = (got["w"][0] - ref["w"][0]).abs()[0].amax(dim=1) / ref["w"][0].abs().max()
    return {**gap, "w_rows": [float(f"{x:.3g}") for x in rows]}


def inversion_card_vs_cpu(G, target, c, strength: float = 0.1) -> dict:
    """An fp32 copy of G, noise strengths 0.1 (the noise takes part), card
    against CPU (inversion_grads), each gradient relative to its largest
    value: the card's fp32, with cuDNN and with PyTorch's own convolutions,
    against the CPU's fp32 (limits INV_W_TOL for w+, INV_GRAD_TOL for the
    rest), and every fp32 run against the CPU in float64 (float64_render), the
    third witness that says which side carries a gap."""
    fp32, cpu = contextlib.nullcontext, torch.float32
    runs = [("cpu32", "cpu", cpu, fp32), ("cpu64", "cpu", torch.float64, float64_render),
            ("card32", "cuda", cpu, fp32),
            ("card32_native", "cuda", cpu, lambda: torch.backends.cudnn.flags(enabled=False))]
    g = inversion_grads(G, target, c, runs, strength)
    err = {f"{a}_vs_{b}": grad_gap(g[a], g[b]) for a, b in (
        ("card32", "cpu32"), ("card32_native", "cpu32"), ("card32", "cpu64"),
        ("card32_native", "cpu64"), ("cpu32", "cpu64"))}
    over = {f"{pair} {k}": e[k] for pair, e in err.items() for k in ("w", "noise", "pti")
            if e[k] > (INV_W_TOL if pair.startswith("card32_vs") and k == "w" else INV_GRAD_TOL)}
    if over:
        raise RuntimeError(f"inversion: fp32 gradients / max|grad| over their limits {over} (w+ "
                           f"of the card with cuDNN {INV_W_TOL}, the rest {INV_GRAD_TOL}): {err}")
    return err


def write_loss_nets(root: str) -> dict:
    """Random-init weight files for the encoder trainer: BiSeNet(20) and
    ArcFace IR-SE50 (the JAX packages' inits), the VGG19 trunk and the LPIPS
    trunk + lin weights (numpy RandomState draws, N(0, 0.05²) convs)."""
    import os

    from ide3d_tpu_torch.metrics.features import VGG16Features
    from ide3d_tpu_torch.metrics.lpips import LPIPS
    from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
    from ide3d_tpu_torch.models.bisenet import BiSeNet

    def trunk(module, prefixes, seed):
        rs = np.random.RandomState(seed)
        return {k: torch.as_tensor(rs.randn(*v.shape).astype(np.float32)
                                   * (0.05 if v.ndim == 4 else 0.0 if k.endswith("bias") else 0.1))
                for k, v in module.state_dict().items() if k.startswith(prefixes)}

    lp = trunk(LPIPS(), ("vgg.features.", "lin"), 2)
    lp.update({k: v.abs() for k, v in lp.items() if k.startswith("lin")})
    files = {"bisenet": BiSeNet(20).init().state_dict(),
             "vgg-weights": trunk(VGG16Features(cfg_name="vgg19"), ("features.",), 1),
             "lpips-weights": lp, "arcface-weights": ArcFaceIRSE50().init().state_dict()}
    out = {}
    for name, sd in files.items():
        out[name] = os.path.join(root, f"{name}.pth")
        torch.save(sd, out[name])
    return out


def inversion_encoder(snap: str, root: str, nets: dict, smi: str) -> dict:
    """apps.train_hybrid_encoder.main at --batch 4 for 3 steps on 8 labelled
    512² images with seg masks, both branches, every loss network from its
    file: K1 per step, finite stats, event ms per step, peak; then --resume of
    its snapshot restores E, Adam and the step."""
    import os

    from ide3d_tpu_torch.apps import train_hybrid_encoder
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint

    imgs, segs = write_dataset(os.path.join(root, "enc_data"), 8, INV_RES)
    argv = ["--network", snap, "--data", imgs, "--seg", segs, "--batch", str(ENC_BATCH),
            "--snap", str(ENC_STEPS), "--max-steps", str(ENC_STEPS), "--device", "cuda"]
    for name, path in nets.items():
        argv += [f"--{name}", path]
    meter = StepMeter()
    restore = _metered(meter)
    torch.cuda.reset_peak_memory_stats()
    meter.label = "encoder"
    try:
        t0 = time.perf_counter()
        state = train_hybrid_encoder.main(argv + ["--outdir", os.path.join(root, "enc")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        meter.label = None
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    meter.check({"encoder": INV_LAUNCHES["encoder"]}, "train_hybrid_encoder")
    if len(meter.launches("encoder")) != ENC_STEPS:
        raise RuntimeError(f"train_hybrid_encoder: {len(meter.launches('encoder'))} steps counted")
    with open(os.path.join(root, "enc", "stats.jsonl")) as f:
        line = json.loads(f.readline())
    want = {"loss_ws", "loss_gen_l2", "loss_gen_entropy", "loss_cycle", "loss_real_l2", "loss_vgg",
            "loss_lpips", "loss_id", "loss_real_entropy", "loss_real_cycle", "loss_total"}
    if not want <= set(line) or not all(np.isfinite(line[k]) for k in want):
        raise RuntimeError(f"train_hybrid_encoder: stats line {line}")
    snap_e = os.path.join(root, "enc", f"encoder-{ENC_STEPS:08d}")
    saved, meta = load_checkpoint(snap_e)
    resumed = train_hybrid_encoder.main(argv + ["--outdir", os.path.join(root, "enc_r"),
                                                "--resume", snap_e])
    _same_state(saved["E"], resumed.E.state_dict(), "E")
    _same_state(saved["opt_e"], resumed.opt_e.state_dict(), "opt_e")
    _same_state(state.E.state_dict(), resumed.E.state_dict(), "E")
    if resumed.step != ENC_STEPS or meta["step"] != ENC_STEPS:
        raise RuntimeError(f"train_hybrid_encoder --resume: step {resumed.step}, meta {meta}")
    ms = meter.step_ms("encoder")
    print(f"inversion: apps.train_hybrid_encoder.main --batch {ENC_BATCH}, {ENC_STEPS} steps, "
          f"HybridEncoder(512, 10, 8) fp32 + GeneratorConfig() bf16, both branches, random-init "
          f"--bisenet --vgg-weights --lpips-weights --arcface-weights ({smi}): step ms after the "
          f"first {[round(t, 3) for t in ms]}, peak {peak:.3f} GiB, K1 (forward, backward) per step "
          f"{meter.launches('encoder')}; losses at step 0 "
          f"{json.dumps({k: float(f'{line[k]:.5g}') for k in sorted(want)})}; wall {run_s:.1f} s "
          f"(network files and init included); --resume restored E, Adam and step {resumed.step}",
          flush=True)
    return {"launches": meter.launches("encoder"), "ms": ms, "median_ms": statistics.median(ms),
            "peak_gib": peak, "snapshot": snap_e}


def inversion_clis(snap: str, imgs: str, masks: str, root: str, names: list, enc: str,
                   nets: dict) -> dict:
    """finetune_hybrid_encoder (3 steps), latent_creator (2 images, 5 steps) and
    calc_losses_on_images l2,lpips,id (targets against run_pti's reconstructions)."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import calc_losses_on_images, finetune_hybrid_encoder, latent_creator

    n0 = names[0]
    finetune_hybrid_encoder.main([
        "--network", snap, "--encoder", enc, "--img", os.path.join(imgs, f"{n0}.png"),
        "--mask", os.path.join(masks, f"{n0}.png"), "--target-code",
        os.path.join(root, "pti", f"{n0}.npz"), "--steps", "3", "--outdir",
        os.path.join(root, "ft"), "--device", "cuda"])
    latent_creator.main(["--network", snap, "--images", imgs, "--steps", "5", "--outdir",
                         os.path.join(root, "latents"), "--device", "cuda"])
    for n in names:
        if not np.isfinite(np.load(os.path.join(root, "latents", f"{n}.npz"))["ws"]).all():
            raise RuntimeError(f"latent_creator: non-finite latent for {n}")
    recon = os.path.join(root, "recon")
    os.makedirs(recon)
    for n in names:
        pair = np.asarray(PIL.Image.open(os.path.join(root, "pti", f"{n}_compare.png")))
        PIL.Image.fromarray(pair[:, pair.shape[1] // 2:]).save(os.path.join(recon, f"{n}.png"))
    res = calc_losses_on_images.main([
        "--mode", "l2,lpips,id", "--data-a", imgs, "--data-b", recon, "--lpips-weights",
        nets["lpips-weights"], "--arcface-weights", nets["arcface-weights"], "--device", "cuda"])
    if set(res) != {"l2", "lpips", "id"} or not all(np.isfinite(v["mean"]) for v in res.values()):
        raise RuntimeError(f"calc_losses_on_images: {res}")
    return res


def face_nets_card_vs_cpu(imgs: str, e4e_model) -> dict:
    """ArcFace embed_faces (2 targets), BiSeNet (1 target) and e4e (both
    variants, one 256² target) as fp32 copies, card against CPU, TF32 off; the
    IR-SE50 convs at half the JAX init's std (at its std the body's activations
    grow ~1e6-fold and fp32 rounding takes over). max abs err / max|output|."""
    import copy
    import os

    from ide3d_tpu_torch.apps.infer_hybrid_encoder import load_image
    from ide3d_tpu_torch.metrics.features import resize
    from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
    from ide3d_tpu_torch.models.bisenet import BiSeNet

    x = torch.as_tensor(np.stack([load_image(os.path.join(imgs, f), INV_RES)
                                  for f in sorted(os.listdir(imgs))]))
    arc = ArcFaceIRSE50().init()
    with torch.no_grad():
        for p in arc.parameters():
            if p.ndim == 4:
                p.mul_(0.5)
    nets = {"arcface": (arc, lambda m, t: m.embed_faces(t), x),
            "bisenet": (BiSeNet(20).init(), lambda m, t: m(t), x[:1])}
    for v in ("e4e", "gradual"):
        m = copy.deepcopy(e4e_model).cpu()
        m.variant = v
        nets[f"e4e_{v}"] = (m, lambda m, t: m(t), resize(x[:1], 256))
    err = {}
    for name, (m, fn, inp) in nets.items():
        with torch.no_grad():
            ref = fn(m.eval(), inp)
            got = fn(m.cuda(), inp.cuda()).cpu()
        _check_finite(f"{name} card", [got])
        err[name] = float((got - ref).abs().max() / ref.abs().max())
        m.cpu()
    if max(err.values()) > FACE_TOL:
        raise RuntimeError(f"face nets fp32 cuda vs cpu / max|output| {err} (limit {FACE_TOL})")
    return err


def phase_inversion(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import load_image
    from ide3d_tpu_torch.models.generator import GeneratorConfig
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        write_snapshot(snap, GeneratorConfig(), seed=0)
        G = common.load_generator(snap, "cuda")
        imgs, masks = write_targets(G, root, INV_TARGETS)
        inv = inversion_pti(snap, imgs, root, smi)
        target = torch.as_tensor(load_image(os.path.join(imgs, f"{inv['names'][0]}.png"),
                                            INV_RES))[None]
        grads = inversion_card_vs_cpu(G, target, torch.as_tensor(CANONICAL_POSE_25)[None])
        del G
        nets = write_loss_nets(root)
        enc = inversion_encoder(snap, root, nets, smi)
        clis = inversion_clis(snap, imgs, masks, root, inv["names"], enc["snapshot"], nets)
        faces = face_nets_card_vs_cpu(imgs, inv.pop("e4e_model"))
    med = inv["median_ms"]
    arith = 450 * med["projector"] + 350 * med["pti"]
    gaps = "; ".join(f"{pair}: w+ {e['w']:.3g} (rows 0-4 {e['w_rows'][:5]}), noise "
                     f"{e['noise']:.3g}, PTI {e['pti']:.3g}" for pair, e in grads.items())
    print(f"inversion: fp32 copies of the flagship, noise strengths 0.1, the CPU's importance "
          f"depths on every run, max abs err / max|grad| of the projector step's w+ and noise "
          f"gradients and the PTI step's (card32: cuDNN convolutions, card32_native: PyTorch's "
          f"own, cpu64: the CPU in float64; limits {INV_W_TOL:g} for card32's w+, "
          f"{INV_GRAD_TOL:g} for the rest): {gaps}; ArcFace / BiSeNet / e4e fp32 cuda vs cpu "
          f"max abs err / max|output| {json.dumps({k: float(f'{v:.3g}') for k, v in faces.items()})} "
          f"(limit {FACE_TOL:g}); finetune_hybrid_encoder 3 steps, latent_creator 2 images x 5 "
          f"steps, calc_losses_on_images {json.dumps(clis)}; arithmetic, not measured: a default "
          f"run_pti (450 projector + 350 PTI steps) at these medians = {arith / 1e3:.1f} s a "
          f"target; phase 10 wall {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return {**inv, "grads": grads, "encoder": enc, "faces": faces, "arith_s": arith / 1e3}


def inversion_launches(inv: dict, i: int) -> dict:
    """Phase 10's launches of K1 (i = 0) or its backward (i = 1): per step of
    each loop and per _save_viz (all equal; checked), and the totals."""
    per = {"projector_step": inv["main"]["launches"]["projector"],
           "pti_step": inv["main"]["launches"]["pti"], "save_viz": inv["main"]["launches"]["viz"],
           "pti_step_join_view_locality": inv["join"]["launches"]["pti_jv_loc"],
           "save_viz_video": inv["join"]["launches"]["viz_video"],
           "encoder_step": inv["encoder"]["launches"]}
    out = {k: v[0][i] for k, v in per.items()}
    out["run_pti_total"] = sum(n[i] for k in ("projector", "pti", "viz")
                               for n in inv["main"]["launches"][k])
    out["encoder_total"] = sum(n[i] for n in inv["encoder"]["launches"])
    return out


EDIT_MAPPER_STEPS, EDIT_NADA_STEPS, EDIT_OPT_STEPS = 6, 4, 5
EDIT_LAUNCHES = {"mapper_id": (2, 1), "mapper": (1, 1), "nada": (2, 0), "nada_geometry": (2, 1),
                 "optimize": (1, 1)}
EDIT_YAWS = "-0.3,0,0.3"
VIZ_TYPES = ("image", "raw", "seg", "depth", "normals")
ANIM_MASKS = 8
# fp32 with TF32 off. CLIP's embeddings, card against CPU: 1e-5 x max. The
# mapper's and NADA's gradients against the CPU in float64: 1e-4 x max|grad|,
# or no farther than the CPU's own fp32 is from float64 where that is farther.
# Both devices' fp32 read ~1e-3 there: the CPU's fp32 1.09e-3 (mapper), 1.48e-3
# (mapper without the ID term), 6.6e-4 (NADA), the card's 3.0e-4, 4.6e-4,
# 4.1e-4 (H100 80GB HBM3, 700 W; PERF.md, open questions).
CLIP_TOL, EDIT_GRAD_TOL = 1e-5, 1e-4


@contextlib.contextmanager
def adam_steps(meter: StepMeter, label: str):
    """Inside, `meter` marks `label` at every Adam step (K1 launched before
    the block is not counted; after the last step it is, as "between"), and
    records the block's peak memory. cuDNN runs at TF32 on, PyTorch's default,
    as a user's process."""
    real = torch.optim.Adam.step

    def step(opt, *a, **kw):
        out = real(opt, *a, **kw)
        meter.mark(label)
        return out

    zero_k1_counts()
    meter.mark("between")
    torch.cuda.reset_peak_memory_stats()
    torch.optim.Adam.step, meter.label = step, label
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            yield
    finally:
        torch.optim.Adam.step, meter.label = real, None
        torch.cuda.synchronize()
        meter.peak[label] = torch.cuda.max_memory_allocated() / 2**30
        meter.mark("between")


def write_editing_files(root: str) -> dict:
    """A random-init full-width CLIP ViT-B/32 (the port's CLIP at ClipConfig()
    from init(0), the OpenAI state-dict layout, fp16 on disk), a synthetic BPE
    vocab (.gz, 3 merges) and a random-init IR-SE50 (ArcFace's JAX init)."""
    import gzip
    import os

    from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
    from ide3d_tpu_torch.models.clip import CLIP, ClipConfig

    files = {k: os.path.join(root, n) for k, n in (("clip", "clip_vit_b32.pt"), ("bpe", "bpe.txt.gz"),
                                                    ("ir_se50", "ir_se50.pth"))}
    torch.save({k: v.half() for k, v in CLIP(ClipConfig()).init(0).state_dict().items()},
               files["clip"])
    with gzip.open(files["bpe"], "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nh a\nha ir</w>\np u\n")
    torch.save(ArcFaceIRSE50().init().half().state_dict(), files["ir_se50"])
    return files


def edit_step_k1(meter: StepMeter):
    """Patches the renderer's K1 so that the first K1 call of a `mapper_id`
    step with differentiable values keeps its inputs and, through hooks, the
    step's own cotangents. Returns (captured, restore)."""
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    captured = {}

    def capture(*args, **kw):
        out = ray_march.sort_integrate(*args, **kw)
        if not captured and meter.label == "mapper_id" and args[1].requires_grad:
            captured.update(args=tuple(a.detach() for a in args), kw=kw, cot=[None] * 3)
            for i, t in enumerate(out):
                if t.requires_grad:
                    t.register_hook(lambda g, i=i: captured["cot"].__setitem__(
                        i, None if g is None else g.detach()))
        return out

    renderer.sort_integrate = capture

    def restore():
        renderer.sort_integrate = ray_march.sort_integrate

    return captured, restore


def k1_on_captured(captured: dict, label: str) -> dict:
    """K1 against its plain version on captured inputs (bf16 <= 1e-3), and its
    backward on the captured cotangents against autograd through plain (<= 1e-2
    x max|grad|) when they were captured."""
    from ide3d_tpu_torch.ops import ray_march

    args, kw = captured["args"], captured["kw"]
    with torch.no_grad():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    fwd = max_err(got, ref)
    out = {"fwd_err": fwd, "dtype": str(args[1].dtype),
           "shape": [list(args[1].shape), list(args[3].shape)]}
    if "cot" in captured:
        B, Rr, _, c1 = args[1].shape
        cot = [torch.zeros(B, Rr, n, device="cuda") if g is None else g.float().contiguous()
               for g, n in zip(captured["cot"], (c1 - 1, 1, 1))]
        with torch.no_grad():
            gb = ray_march.sort_integrate_backward(*args, *cot, **kw)
            rb = ray_march.sort_integrate_backward_plain(*args, *cot, **kw)
        _check_finite(f"{label} K1 backward", gb)
        out["bwd_err"] = rel_err(gb, rb)
    torch.cuda.synchronize()
    _check_finite(f"{label} K1", got)
    if fwd > 1e-3 or out.get("bwd_err", 0.0) > 1e-2:
        raise RuntimeError(f"{label}: K1 vs plain {out} (limits 1e-3, backward 1e-2 x max|grad|)")
    return out


def editing_train(snap: str, files: dict, root: str) -> dict:
    """train_styleclip_mapper (batch 2, with the ID loss and without), its
    mapper through styleclip_edit at 3 yaws, train_nada (geometry frozen and
    --train-geometry), optimize_latent: K1 launches per step, event ms per
    step, peaks, the edit frame against G.synthesis, NADA's frozen parameters."""
    import os

    from ide3d_tpu_torch.apps import common, styleclip_edit, train_nada, train_styleclip_mapper
    from ide3d_tpu_torch.models.clip import SimpleTokenizer, load_clip
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
    from ide3d_tpu_torch.train import nada, styleclip

    meter = StepMeter()
    base = ["--network", snap, "--clip", files["clip"], "--bpe", files["bpe"], "--device", "cuda"]
    captured, restore = edit_step_k1(meter)
    try:
        with adam_steps(meter, "mapper_id"):
            mapper = train_styleclip_mapper.main(base + [
                "--description", "a face with purple hair", "--ir-se50", files["ir_se50"],
                "--steps", str(EDIT_MAPPER_STEPS), "--outdir", os.path.join(root, "mapper_id")])
    finally:
        restore()
    with adam_steps(meter, "mapper"):
        train_styleclip_mapper.main(base + ["--description", "purple hair", "--steps", "3",
                                            "--outdir", os.path.join(root, "mapper")])

    G = common.load_generator(snap, "cuda")
    c0 = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.no_grad():
        ws = G.mapping(torch.as_tensor(np.random.RandomState(5).randn(1, G.z_dim),
                                       dtype=torch.float32, device="cuda"), c0, truncation_psi=0.7)
    np.savez(os.path.join(root, "w.npz"), ws=ws.cpu().numpy())
    zero_k1_counts()
    edit = styleclip_edit.main(["--network", snap, "--latents", os.path.join(root, "w.npz"),
                                "--mapper", os.path.join(root, "mapper_id", "mapper"),
                                f"--yaws={EDIT_YAWS}", "--outdir", os.path.join(root, "edit"),
                                "--device", "cuda"])
    edit_launches = k1_launches("styleclip_edit")[0]
    n_yaw = len(EDIT_YAWS.split(","))
    with torch.no_grad():
        want_edit = ws + 0.1 * mapper(ws)
        gaps = {"batch_2": 0.0, "batch_1": 0.0}
        for k, yaw in enumerate(float(y) for y in EDIT_YAWS.split(",")):
            c = make_label_25(look_at_pose(yaw + np.pi / 2, np.pi / 2, [0.0, 0.0, 0.0], radius=2.7,
                                           device="cuda"))
            pair = G.synthesis(torch.cat([ws, want_edit]), c.expand(2, -1)).float().cpu().numpy()
            one = G.synthesis(want_edit, c).float().cpu().numpy()
            got = np.rint((edit["frames"][2 * k + 1] + 1) * 127.5).clip(0, 255)
            gaps["batch_2"] = max(gaps["batch_2"], float(np.abs(
                got - np.rint((pair[1] + 1) * 127.5).clip(0, 255)).max()))
            gaps["batch_1"] = max(gaps["batch_1"], float(np.abs(
                got - np.rint((one[0] + 1) * 127.5).clip(0, 255)).max()))
    if edit_launches != n_yaw or gaps["batch_2"] > 1 or not np.isfinite(edit["frames"]).all():
        raise RuntimeError(f"styleclip_edit: K1 {edit_launches} for {n_yaw} yaws (want one a yaw), "
                           f"uint8 gap to G.synthesis {gaps} (limit 1 at the CLI's batch)")

    with adam_steps(meter, "nada"):
        out = train_nada.main(base + ["--source", "photo", "--target", "sketch", "--steps",
                                      str(EDIT_NADA_STEPS), "--outdir", os.path.join(root, "nada")])
    trained = {f"synthesis.{n}" for n, _ in nada.nada_parameters(G)}
    s0, st = G.state_dict(), out["G"].state_dict()
    s1 = common.load_generator(out["path"], "cuda").state_dict()
    frozen_same = all(torch.equal(s0[k], st[k]) for k in s0 if k not in trained)
    moved = sum(not torch.equal(s0[k], st[k]) for k in trained)
    if (not frozen_same or not moved or not all(torch.equal(s1[k], st[k]) for k in st)
            or not np.isfinite(out["losses"]).all()):
        raise RuntimeError(f"train_nada: frozen parameters bit-identical {frozen_same}, "
                           f"{moved}/{len(trained)} trained tensors moved, losses {out['losses']}")
    nada_first = out["losses"][0]
    with adam_steps(meter, "nada_geometry"):
        out = train_nada.main(base + ["--source", "photo", "--target", "sketch", "--steps", "2",
                                      "--train-geometry", "--outdir", os.path.join(root, "nada_geo")])
    if not np.isfinite(out["losses"]).all():
        raise RuntimeError(f"train_nada --train-geometry: losses {out['losses']}")
    del out

    clip_model = load_clip(files["clip"], device="cuda").requires_grad_(False)
    tokens = torch.as_tensor(SimpleTokenizer(bpe_path=files["bpe"]).tokenize(
        ["purple hair"], context_length=clip_model.cfg.context_length), device="cuda")
    with adam_steps(meter, "optimize"):
        w_opt = styleclip.optimize_latent(G, clip_model, tokens, ws, steps=EDIT_OPT_STEPS, lr=0.1,
                                          log_every=0)
    if not torch.isfinite(w_opt).all() or not float((w_opt - ws).abs().max()) > 0:
        raise RuntimeError("optimize_latent: the latent did not move or is not finite")
    meter.check(EDIT_LAUNCHES, "editing")
    counts = {k: len(meter.launches(k)) for k in EDIT_LAUNCHES}
    want = {"mapper_id": EDIT_MAPPER_STEPS, "mapper": 3, "nada": EDIT_NADA_STEPS,
            "nada_geometry": 2, "optimize": EDIT_OPT_STEPS}
    if counts != want:
        raise RuntimeError(f"editing: steps counted {counts}, want {want}")
    k1 = k1_on_captured(captured, "mapper step")
    return {"launches": {k: meter.launches(k)[0] for k in EDIT_LAUNCHES},
            "ms": {k: meter.step_ms(k) for k in EDIT_LAUNCHES}, "peak_gib": meter.peak,
            "k1": k1, "edit_launches": edit_launches, "edit_gap": gaps, "nada_first_loss": nada_first,
            "G": G, "clip": clip_model, "tokens": tokens}


def viz_and_animation(G, snap: str, root: str) -> dict:
    """VizRenderer at 48+48: every render type, cached and uncached renders
    timed by CUDA events with K1 and generate_planes counted, capture_layers,
    the page and /render through VizServer.handle, K1 at the render's inputs
    against plain; infer_face_animation on 8 masks with --orbit and
    converter_log_to_video on a recorded 4-edit session, K1 counted per frame."""
    import io
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import converter_log_to_video, infer_face_animation, viz_renderer
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import build_encoder
    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.models.generator import Ide3dSynthesisNetwork
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    planes = {"n": 0}
    real_planes = Ide3dSynthesisNetwork.generate_planes

    def counted_planes(self, *a, **kw):
        planes["n"] += 1
        return real_planes(self, *a, **kw)

    captured = {}

    def capture(*args, **kw):
        if not captured:
            captured.update(args=tuple(a.detach() for a in args), kw=kw)
        return ray_march.sort_integrate(*args, **kw)

    r = viz_renderer.VizRenderer(G)
    runs = {"uncached": [viz_renderer.VizState(seed=s) for s in range(3)],
            "cached": [viz_renderer.VizState(seed=2, yaw=y) for y in np.linspace(-0.4, 0.4, 9)]
            + [viz_renderer.VizState(seed=2, yaw=0.1, render_type=t) for t in VIZ_TYPES[1:]]}
    times, launches, peak, shapes = {"cached": [], "uncached": [], "types": {}}, [], {}, {}
    Ide3dSynthesisNetwork.generate_planes = counted_planes
    renderer.sort_integrate = capture
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            for kind, sts in runs.items():
                torch.cuda.reset_peak_memory_stats()
                for st in sts:
                    zero_k1_counts()
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                    img, info = r.render(st)
                    e1.record()
                    torch.cuda.synchronize()
                    if info["plane_cached"] != (kind == "cached") or img.dtype != np.uint8:
                        raise RuntimeError(f"viz: {st} plane_cached {info['plane_cached']}")
                    ms = e0.elapsed_time(e1)
                    if st.render_type == "image":
                        times[kind].append(ms)
                    else:
                        times["types"][st.render_type] = ms
                    launches.append(k1_launches(f"viz {st.render_type}")[0])
                    shapes[st.render_type] = img.shape
                peak[kind] = torch.cuda.max_memory_allocated() / 2**30
            zero_k1_counts()
            caps = r.capture_layers(viz_renderer.VizState(seed=1))
            cap_launches = k1_launches("viz capture_layers")[0]
            server = viz_renderer.VizServer(r)
            status, _, page, _ = server.handle("/", {})
            status2, ctype, png, _ = server.handle("/render", {"seed": "2", "yaw": "0.1", "type": "seg"})
    finally:
        Ide3dSynthesisNetwork.generate_planes = real_planes
        renderer.sort_integrate = ray_march.sort_integrate
    bad = [n for n, e in caps.items() if not np.isfinite([e["mean"], e["std"]]).all()]
    if (planes["n"] != 3 + 1 or set(launches) != {1} or cap_launches != 1 or bad
            or status != 200 or status2 != 200 or ctype != "image/png"
            or np.asarray(PIL.Image.open(io.BytesIO(png))).shape != (64, 64, 3)):
        raise RuntimeError(f"viz: generate_planes {planes['n']} (want 4), K1 per render "
                           f"{sorted(set(launches))}, capture_layers K1 {cap_launches}, non-finite taps "
                           f"{bad}, routes {status} {status2} {ctype}")
    k1 = k1_on_captured(captured, "viz render")

    E = build_encoder(G, "random:0", "cuda")
    per_call = []
    real_edit = PainterSession.edit

    def counted_edit(self, *a, **kw):
        zero_k1_counts()
        out = real_edit(self, *a, **kw)
        per_call.append(k1_launches("PainterSession.edit")[0])
        return out

    masks = os.path.join(root, "target_masks")
    sess = PainterSession(G=G, E=E, record=True, device="cuda")
    sess.set_seed(3)
    mask_files = sorted(os.listdir(masks))
    for f, yaw in zip(mask_files[:4], (0.0, 0.0, 0.3, 0.3)):
        sess.edit(np.asarray(PIL.Image.open(os.path.join(masks, f))), yaw=yaw)
    sess.save_log(os.path.join(root, "session.npz"))
    PainterSession.edit = counted_edit
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            t0 = time.perf_counter()
            anim = infer_face_animation.main(["--network", snap, "--masks", masks, "--orbit",
                                              "--output", os.path.join(root, "anim.mp4"),
                                              "--device", "cuda"])
            anim_s = time.perf_counter() - t0
            anim_calls, per_call[:] = list(per_call), []
            replay = converter_log_to_video.main(["--network", snap, "--log",
                                                  os.path.join(root, "session.npz"), "--seed", "3",
                                                  "--output", os.path.join(root, "replay.mp4"),
                                                  "--device", "cuda"])
            replay_calls = list(per_call)
    finally:
        PainterSession.edit = real_edit
    if anim_calls != [2] * ANIM_MASKS or replay_calls != [2, 1, 2, 1] or not (
            os.path.exists(anim) and os.path.exists(replay)):
        raise RuntimeError(f"face animation K1 per frame {anim_calls} (want 2 each), log replay "
                           f"{replay_calls} (want [2, 1, 2, 1]), files {anim} {replay}")
    return {"ms": times, "peak_gib": peak, "shapes": shapes, "capture_launches": cap_launches,
            "planes": planes["n"], "k1": k1, "taps": len(caps),
            "anim_launches": anim_calls, "anim_s": anim_s, "replay_launches": replay_calls}


def editing_comparison(snap: str, imgs: str, root: str) -> dict:
    """run_pti (1 target, 2 + 2 steps), edit_comparison on its outdir (an
    InterFaceGAN direction at 4 factors, 1 GANSpace component at 9) and a short
    experiment_runner (run_pti 2 + 2, --compare); strips written and K1 counted."""
    import os
    import shutil

    import PIL.Image

    from ide3d_tpu_torch.apps import edit_comparison, experiment_runner, run_pti

    one = os.path.join(root, "one")
    os.makedirs(one)
    name = sorted(os.listdir(imgs))[0]
    shutil.copy(os.path.join(imgs, name), os.path.join(one, name))
    run_pti.main(["--network", snap, "--images", one, "--outdir", os.path.join(root, "cmp_pti"),
                  "--projector-steps", "2", "--pti-steps", "2", "--lpips-threshold", "0",
                  "--device", "cuda"])
    np.savez(os.path.join(root, "dirs.npz"),
             smile=np.random.RandomState(6).randn(512).astype(np.float32) * 0.2)
    zero_k1_counts()
    edit_comparison.main(["--network", snap, "--images", one, "--pti", os.path.join(root, "cmp_pti"),
                          "--directions", os.path.join(root, "dirs.npz"), "--interfacegan-max", "1.0",
                          "--ganspace-components", "1", "--outdir", os.path.join(root, "cmp"),
                          "--device", "cuda"])
    cmp_launches = k1_launches("edit_comparison")[0]
    strips = os.listdir(os.path.join(root, "cmp", name[:-4], "concat_images"))
    rec = np.asarray(PIL.Image.open(os.path.join(root, "cmp", name[:-4], "concat_images", "rec.jpg")))
    rc = experiment_runner.main(["--network", snap, "--images", one, "--outdir",
                                 os.path.join(root, "exp"), "--projector-steps", "2", "--pti-steps",
                                 "2", "--lpips-threshold", "0", "--compare", "--device", "cuda"])
    exp_strips = os.listdir(os.path.join(root, "exp", "comparison", name[:-4], "concat_images"))
    if (cmp_launches != 1 + 4 + 9 or len(strips) != 14 or rec.shape != (512, 1024, 3) or rc != 0
            or len(exp_strips) != 19):
        raise RuntimeError(f"edit_comparison: K1 {cmp_launches} (want 14 renders), strips "
                           f"{len(strips)}, rec {rec.shape}; experiment_runner rc {rc}, strips "
                           f"{len(exp_strips)} (want 19)")
    return {"launches": cmp_launches, "strips": len(strips), "exp_strips": len(exp_strips)}


def editing_card_vs_cpu(G, clip_path: str, tokens) -> dict:
    """fp32 copies, TF32 off, card against CPU: CLIP's image and text
    embeddings (2 images at 512², the bicubic preprocessing), a mapper step's
    gradients in the mapper (batch 1; with the CLIP, ID and latent terms, and
    without the ID term; ArcFace at half its init's conv std) and a NADA
    step's in the trained parameters (batch 1, the trained copy's appearance
    moved off the frozen one, renders at noise_mode 'const'), on the card in
    fp32 ("card32"), on the CPU in fp32 ("cpu32") and in float64 ("cpu64",
    float64_render: the third witness); the later runs replay the first's
    importance depths. Returns {"a_vs_b": {quantity: max |a - b| / max |b|}}."""
    import copy

    from ide3d_tpu_torch.editing.latent_editor import LevelsMapper
    from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
    from ide3d_tpu_torch.models.clip import load_clip, make_image_embedder
    from ide3d_tpu_torch.models.generator import Ide3dSynthesisNetwork
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.train import nada, styleclip

    rs = np.random.RandomState(8)
    img = torch.as_tensor(rs.uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32))
    arc = ArcFaceIRSE50().init()
    with torch.no_grad():
        for m in arc.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
    mapper0 = LevelsMapper(G.w_dim, G.num_ws).init(1)
    w0 = (G.mapping.w_avg[None, None].repeat(1, G.num_ws, 1).cpu()
          + torch.as_tensor(rs.randn(1, G.num_ws, G.w_dim).astype(np.float32)) * 0.3)
    z = torch.as_tensor(rs.randn(1, G.z_dim).astype(np.float32))
    tdir = torch.as_tensor(rs.randn(512).astype(np.float32))
    moved = {n: torch.as_tensor(np.asarray(rs.randn(*p.shape), np.float32)) * 0.1
             for n, p in nada.nada_parameters(G)}
    depths, out = [], {}
    real_pdf, real_fwd = renderer.sample_pdf, Ide3dSynthesisNetwork.forward

    def recorded(*a, **kw):
        depths.append(real_pdf(*a, **kw))
        return depths[-1]

    def replayed(*a, **kw):
        replayed.i += 1
        return depths[replayed.i - 1].to(a[0].device, a[0].dtype)

    @contextlib.contextmanager
    def float64_editing():
        """float64_render, and the mapper loss's front camera in float64."""
        real = styleclip._front
        styleclip._front = lambda *a: real(*a).double()
        try:
            with float64_render():
                yield
        finally:
            styleclip._front = real

    runs = (("cpu32", "cpu", torch.float32, contextlib.nullcontext),
            ("cpu64", "cpu", torch.float64, float64_editing),
            ("card32", "cuda", torch.float32, contextlib.nullcontext))
    Ide3dSynthesisNetwork.forward = (lambda self, ws, c, noise_mode="const", generator=None, **kw:
                                     real_fwd(self, ws, c, **kw))
    try:
        for i, (label, dev, dtype, context) in enumerate(runs):
            renderer.sample_pdf, replayed.i = (replayed if i else recorded), 0
            with context():
                clip_model = load_clip(clip_path, dtype=str(dtype)[6:], device=dev)
                embed = make_image_embedder(clip_model.requires_grad_(False))
                with torch.no_grad():
                    res = {"image": embed(img.to(dev, dtype)),
                           "text": clip_model.encode_text(tokens.to(dev))}
                Gx = fp32_copy(G, dev).to(dtype).requires_grad_(False)
                a = copy.deepcopy(arc).to(dev, dtype).eval().requires_grad_(False)
                with torch.enable_grad():
                    for key, cfg in (("mapper", styleclip.StyleClipConfig()),
                                     ("mapper_no_id", styleclip.StyleClipConfig(id_lambda=0.0))):
                        mapper = copy.deepcopy(mapper0).to(dev, dtype)
                        loss, _ = styleclip.styleclip_loss(Gx, mapper, clip_model, tokens.to(dev),
                                                           w0.to(dev, dtype), cfg, a.embed_faces)
                        res[key] = torch.autograd.grad(loss, list(mapper.parameters()))
                    G_train = nada.init_nada(Gx)
                    params = dict(G_train.synthesis.named_parameters())
                    with torch.no_grad():
                        for n, d in moved.items():
                            params[n].add_(d.to(dev, dtype))
                    trained = [p for _, p in nada.nada_parameters(G_train)]
                    c = torch.as_tensor(CANONICAL_POSE_25, device=dev, dtype=dtype)[None]
                    loss = nada.nada_loss(G_train, Gx, embed, (tdir / tdir.norm()).to(dev, dtype),
                                          z.to(dev, dtype), c, torch.Generator(device=dev))
                    res["nada"] = torch.autograd.grad(loss, trained)
            out[label] = {k: [t.detach().double().cpu() for t in (v if isinstance(v, tuple) else [v])]
                          for k, v in res.items()}
            for k, v in out[label].items():
                _check_finite(f"editing card vs cpu {label} {k}", v)
            del Gx, G_train, clip_model
            if i and replayed.i != len(depths):
                raise RuntimeError(f"editing card vs cpu: {replayed.i} importance draws replayed "
                                   f"of {len(depths)}")
    finally:
        renderer.sample_pdf, Ide3dSynthesisNetwork.forward = real_pdf, real_fwd
    if len(depths) != 5:
        raise RuntimeError(f"editing card vs cpu: {len(depths)} importance draws recorded, want 5")
    return {f"{a}_vs_{b}": {k: max(float((g - r).abs().max()) for g, r in zip(out[a][k], out[b][k]))
                            / max(float(r.abs().max()) for r in out[b][k]) for k in out[b]}
            for a, b in (("card32", "cpu32"), ("card32", "cpu64"), ("cpu32", "cpu64"))}


def phase_editing(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        write_snapshot(snap, GeneratorConfig(), seed=0)
        files = write_editing_files(root)
        tr = editing_train(snap, files, root)
        G = tr.pop("G")
        imgs, _ = write_targets(G, root, ANIM_MASKS)
        vz = viz_and_animation(G, snap, root)
        cmp = editing_comparison(snap, imgs, root)
        tokens = tr.pop("tokens")
        del tr["clip"]
        grads = editing_card_vs_cpu(G, files["clip"], tokens)
        del G
    limits = {k: CLIP_TOL for k in ("image", "text")}
    limits.update({k: max(EDIT_GRAD_TOL, grads["cpu32_vs_cpu64"][k])
                   for k in ("mapper", "mapper_no_id", "nada")})
    held = {k: grads["card32_vs_cpu32" if k in ("image", "text") else "card32_vs_cpu64"][k]
            for k in limits}
    over = {k: (e, limits[k]) for k, e in held.items() if e > limits[k]}
    if over:
        raise RuntimeError(f"editing: fp32 card over its limits (CLIP against the CPU's fp32, "
                           f"gradients against its float64): {over}; all {grads}")
    med = {k: statistics.median(v) for k, v in tr["ms"].items() if v}
    vmed = {k: statistics.median(vz["ms"][k]) for k in ("cached", "uncached")}
    print(f"editing: GeneratorConfig() bf16 snapshot, random-init ClipConfig() ViT-B/32, TF32 on for "
          f"the timed runs ({smi}): event ms per step median {json.dumps({k: round(v, 3) for k, v in med.items()})} "
          f"(each {json.dumps({k: [round(t, 3) for t in v] for k, v in tr['ms'].items()})}); peak GiB "
          f"{json.dumps({k: round(v, 3) for k, v in tr['peak_gib'].items()})}; K1 (forward, backward) "
          f"per step {json.dumps(tr['launches'])}; styleclip_edit K1 {tr['edit_launches']} for 3 yaws, "
          f"edit frame vs G.synthesis uint8 gap {tr['edit_gap']} (limit 1 at the CLI's batch 2); NADA's "
          f"first loss {tr['nada_first_loss']!r}, frozen parameters bit-identical; K1 on a mapper "
          f"step's inputs ({tr['k1']['dtype']} {tr['k1']['shape']}) vs plain {tr['k1']['fwd_err']:.3g} "
          f"(limit 1e-3), its backward on the step's cotangents {tr['k1']['bwd_err']:.3g} x max|grad| "
          f"(limit 1e-2)", flush=True)
    print(f"editing: VizRenderer 48+48 ({smi}): event ms cached median {vmed['cached']:.3f} "
          f"({[round(t, 3) for t in vz['ms']['cached']]}), uncached {vmed['uncached']:.3f} "
          f"({[round(t, 3) for t in vz['ms']['uncached']]}), cached seg/depth/normals/raw {json.dumps({k: round(v, 3) for k, v in vz['ms']['types'].items()})}; peak GiB {json.dumps({k: round(v, 3) for k, v in vz['peak_gib'].items()})}; "
          f"K1 1 a render, capture_layers {vz['capture_launches']} ({vz['taps']} taps), "
          f"generate_planes {vz['planes']} for 4 identities; K1 at the render's inputs "
          f"({vz['k1']['dtype']} {vz['k1']['shape']}) vs plain {vz['k1']['fwd_err']:.3g} (limit 1e-3); "
          f"face animation K1 per frame {vz['anim_launches']} ({vz['anim_s']:.1f} s wall), log replay "
          f"{vz['replay_launches']}; edit_comparison {cmp}; fp32 card vs cpu (TF32 off, max abs err / "
          f"max) {json.dumps({r: {k: float(f'{v:.3g}') for k, v in e.items()} for r, e in grads.items()})} (limits: "
          f"CLIP card32 vs cpu32 {CLIP_TOL:g}; gradients card32 vs cpu64 {EDIT_GRAD_TOL:g} or "
          f"cpu32 vs cpu64 where larger); phase 11 wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {**tr, "median_ms": med, "viz": vz, "viz_median_ms": vmed, "cmp": cmp, "grads": grads}


PREP_PHOTOS = 3  # 512² renders with cached detections; a fourth, 1024², goes through the cascade
PREP_STEPS = 2  # projector and PTI steps of the run_pti leg
PREP_WARM_DETECTS = 5  # timed calls of the cascade on the 1024² photo after the CLI's
PREP_LAUNCHES = {"projector": (1, 1), "pti": (1, 1), "viz": (1, 0)}
NET_TOL = 3e-5  # fp32 with TF32 off, card against CPU, x max(1, |output|)
# Random detectors find no face. Their class logits are shifted by [-b, b],
# b below for R- and O-Net (O-Net's confidences then clear the CLI's 0.9),
# and P-Net's b is solved on the 1024² photo (bias_detectors).
MTCNN_CLASS_BIAS = {"rnet": 1.0, "onet": 2.0}
PNET_MIN_PASS = 24  # P-Net positions of the 1024² photo that pass its threshold, at least
PNET_GAP = 2e-3  # the logit gap P-Net's threshold sits in: > 2.4e-4 of probability
THRESH_MARGIN = 1e-4  # no class probability of the cascade this close to its threshold
# The cascade's net inputs (antialiased bilinear pyramid levels and crops, in
# [-1, 1]) card against CPU: 1e-4 is 1/78 of a uint8 level.
RESIZE_TOL = 1e-4
# O-Net's landmark head gives a frontal five-point layout in box units (the
# five x, then the five y), so the detected face crops like a face.
ONET_LAYOUT = (0.31, 0.69, 0.5, 0.35, 0.65, 0.46, 0.46, 0.64, 0.82, 0.82)
TF_BATCH = 4
# The BFM standard landmarks at the scale align_crop maps to itself at 512²
# (rescale 300 into the 1024 crop, 700 of it resized to 512): an FFHQ-aligned face.
FFHQ_LM_SCALE = 300.0 * 512 / 700


def scaled_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|), fp32 tensors or arrays, finite first."""
    got, ref = torch.as_tensor(got).float().cpu(), torch.as_tensor(ref).float().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise RuntimeError("non-finite output")
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def write_photos(G, root: str) -> tuple:
    """PREP_PHOTOS of G's 512² renders (write_targets) with their detections
    at an FFHQ-aligned frontal layout in detections/<name>.txt, and one more
    render resized to 1024² (PIL bicubic) with none. Returns (dir, names)."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.data.preprocess import LM3D_STD

    photos, _ = write_targets(G, root, PREP_PHOTOS + 1)
    last = os.path.join(photos, f"t{PREP_PHOTOS}.png")
    PIL.Image.open(last).resize((1024, 1024), PIL.Image.BICUBIC).save(
        os.path.join(photos, "wild.png"))
    os.remove(last)
    os.makedirs(os.path.join(photos, "detections"))
    lm = LM3D_STD[:, :2] * FFHQ_LM_SCALE + 255.5
    lm[:, 1] = 511 - lm[:, 1]  # y down
    names = [f"t{i}" for i in range(PREP_PHOTOS)]
    for n in names:
        np.savetxt(os.path.join(photos, "detections", f"{n}.txt"), lm)
    return photos, names


def bias_detectors(nets: dict, photo: np.ndarray) -> dict:
    """Make the random CPU nets find faces on `photo` through all three stages:
    R- and O-Net's class logits shifted by [-b, b] (MTCNN_CLASS_BIAS), O-Net's
    landmark head a frontal layout (ONET_LAYOUT, its weights x 1e-2), and
    P-Net's [-b, b] solved from its class logits over the photo's pyramid, so
    that the threshold 0.6 falls in a gap of PNET_GAP below the
    PNET_MIN_PASS-th best position (or a later one). Returns P-Net's b and
    how many positions pass."""
    import math

    from ide3d_tpu_torch.models.mtcnn import MTCNN

    head = nets["pnet"].conv4_1
    with torch.no_grad():
        head.bias.zero_()
        nets["rnet"].dense5_1.bias.copy_(torch.tensor([-1.0, 1.0]) * MTCNN_CLASS_BIAS["rnet"])
        nets["onet"].dense6_1.bias.copy_(torch.tensor([-1.0, 1.0]) * MTCNN_CLASS_BIAS["onet"])
        nets["onet"].dense6_3.weight.mul_(1e-2)
        nets["onet"].dense6_3.bias.copy_(torch.tensor(ONET_LAYOUT))
    logits = []
    hook = head.register_forward_hook(lambda m, i, o: logits.append((o[:, 1] - o[:, 0]).flatten()))
    try:  # the pyramid alone: no probability reaches a threshold of 2
        MTCNN(nets, steps_threshold=(2.0, 0.7, 0.7)).detect_faces(photo)
    finally:
        hook.remove()
    d = torch.sort(torch.cat(logits).double(), descending=True).values
    wide = torch.nonzero(d[PNET_MIN_PASS - 1:-1] - d[PNET_MIN_PASS:] >= PNET_GAP)
    if not len(wide):
        raise RuntimeError(f"preprocess: no gap of {PNET_GAP:g} in P-Net's logits below "
                           f"the {PNET_MIN_PASS}-th")
    k = int(wide[0]) + PNET_MIN_PASS
    b = (math.log(0.6 / 0.4) - float(d[k - 1] + d[k]) / 2) / 2  # p = sigmoid(d + 2b)
    with torch.no_grad():
        head.bias.copy_(torch.tensor([-b, b]))
    return {"pnet_bias": b, "pnet_pass": k}


def write_prep_weights(root: str, photos: str) -> dict:
    """pnet/rnet/onet.pt from models.mtcnn.init(0), biased toward faces on
    the 1024² photo (bias_detectors), and epoch_20.pth (nested as
    Deep3DFaceRecon's training checkpoint) from FaceReconNet().init(0), in the
    torch.save zip format. Returns their paths, the CPU nets and the biases."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.models import face_recon, mtcnn

    mdir = os.path.join(root, "mtcnn")
    os.makedirs(mdir)
    nets = mtcnn.init(0, device="cpu")
    bias = bias_detectors(nets, np.asarray(PIL.Image.open(os.path.join(photos, "wild.png")).convert("RGB")))
    for name, net in nets.items():
        torch.save(net.state_dict(), os.path.join(mdir, f"{name}.pt"))
    recon = face_recon.FaceReconNet().init(0).eval()
    path = os.path.join(root, "epoch_20.pth")
    torch.save({"net_recon": recon.state_dict(), "epoch": 20}, path)
    return {"mtcnn": mdir, "face_recon": path, "nets": nets, "recon": recon, "bias": bias}


def cascade_card_vs_cpu(nets: dict, photo: np.ndarray) -> dict:
    """detect_faces on the card, every class probability more than
    THRESH_MARGIN from its threshold, held against the cascade's box stages
    on the CPU fed the card's net outputs (boxes, confidences and keypoints
    exactly equal: the thresholds, NMS and rounding see the same numbers); each
    net input the CPU makes (pyramid levels, 24² and 48² crops) against the
    card's (<= RESIZE_TOL) and the CPU net's output on it against the card's
    (<= NET_TOL x scale)."""
    import copy

    from ide3d_tpu_torch.models.mtcnn import MTCNN

    card = {n: copy.deepcopy(net).to("cuda").eval() for n, net in nets.items()}
    calls = {n: [] for n in card}
    hooks = [net.register_forward_hook(
        lambda m, i, o, n=n: calls[n].append((i[0].cpu(), tuple(t.cpu() for t in o))))
        for n, net in card.items()]
    try:
        got = MTCNN(card).detect_faces(photo)
    finally:
        for h in hooks:
            h.remove()
    margin = {}
    for n, t in zip(("pnet", "rnet", "onet"), (0.6, 0.7, 0.7)):
        probs = torch.cat([out[0][..., 1].flatten() for _, out in calls[n]])
        margin[n] = float((probs - t).abs().min())
    if not got or min(margin.values()) <= THRESH_MARGIN:
        raise RuntimeError(f"preprocess: the card's cascade found {len(got)} faces; probability "
                           f"margins to the thresholds {margin} (need > {THRESH_MARGIN:g})")
    errs = {"inputs": {n: 0.0 for n in nets}, "outputs": {n: 0.0 for n in nets}}

    class Replay(torch.nn.Module):
        def __init__(self, name, recorded):
            super().__init__()
            self.name, self.net, self.recorded = name, nets[name], list(recorded)

        def forward(self, x):
            x_card, out_card = self.recorded.pop(0)
            if x.shape != x_card.shape:
                raise RuntimeError(f"preprocess: the CPU cascade fed {tuple(x.shape)} where "
                                   f"the card's took {tuple(x_card.shape)}")
            e = errs["inputs"]
            e[self.name] = max(e[self.name], float((x - x_card).abs().max()))
            e = errs["outputs"]
            e[self.name] = max(e[self.name], *(scaled_err(o, oc) for o, oc in
                                               zip(self.net(x), out_card)))
            return tuple(o.clone() for o in out_card)

    replay = {n: Replay(n, calls[n]) for n in nets}
    want = MTCNN(replay).detect_faces(photo)
    left = {n: len(r.recorded) for n, r in replay.items() if r.recorded}
    if (want != got or left or max(errs["inputs"].values()) > RESIZE_TOL
            or max(errs["outputs"].values()) > NET_TOL):
        raise RuntimeError(f"preprocess: cascade card vs cpu: {len(got)} vs {len(want)} faces, "
                           f"equal {want == got}, card calls not replayed {left}, net inputs "
                           f"(limit {RESIZE_TOL:g}) and outputs (limit {NET_TOL:g} x scale) {errs}")
    return {"found": len(got), "margin": margin, **errs,
            "calls": {n: len(c) for n, c in calls.items()}}


def prep_nets_card_vs_cpu(w: dict, photos: str) -> dict:
    """P-Net on the 1024² photo's first pyramid level, R- and O-Net on batches
    of 64 crops at 24² and 48², FaceReconNet on 4 crops at 224² (its 257
    coefficients and the 25-dim labels): fp32 card against CPU, TF32 off."""
    import copy
    import os

    import PIL.Image

    from ide3d_tpu_torch.models import face_recon, mtcnn

    img = torch.as_tensor(np.asarray(PIL.Image.open(os.path.join(photos, "wild.png")),
                                     np.float32)).permute(2, 0, 1)[None]
    level = (mtcnn._resize(img, 615, 615) - 127.5) * 0.0078125
    rs = np.random.RandomState(12)
    ins = {"pnet": level.permute(0, 2, 3, 1),
           "rnet": torch.as_tensor(rs.uniform(-1, 1, (64, 24, 24, 3)), dtype=torch.float32),
           "onet": torch.as_tensor(rs.uniform(-1, 1, (64, 48, 48, 3)), dtype=torch.float32),
           "face_recon": torch.as_tensor(rs.uniform(0, 1, (4, 224, 224, 3)), dtype=torch.float32)}
    nets = {**w["nets"], "face_recon": w["recon"]}
    errs = {}
    with torch.no_grad():
        for name, net in nets.items():
            ref = net(ins[name])
            got = copy.deepcopy(net).to("cuda")(ins[name].to("cuda"))
            if name == "face_recon":
                errs[name] = scaled_err(got, ref)
                errs["pose_label"] = scaled_err(face_recon.coeffs_to_pose_label(got.cpu().numpy()),
                                                face_recon.coeffs_to_pose_label(ref.numpy()))
            else:  # (probabilities, regression[, landmarks])
                errs[name] = max(scaled_err(g, r) for g, r in zip(got, ref))
    over = {k: e for k, e in errs.items() if e > NET_TOL}
    if over:
        raise RuntimeError(f"preprocess: nets fp32 card vs cpu over {NET_TOL:g} x scale: {over}")
    return errs


@contextlib.contextmanager
def prep_stage_timer(ms: dict, detections: list):
    """Times preprocess_in_the_wild's stages per call (host clock around a
    synchronised call): MTCNN.detect_faces (its results kept in
    `detections`), the FaceReconNet pass, and align_crop at 224² and at 512²."""
    from ide3d_tpu_torch.data import preprocess
    from ide3d_tpu_torch.models import face_recon, mtcnn

    real = (mtcnn.MTCNN.detect_faces, face_recon.FaceReconNet.forward, preprocess.align_crop)

    def timed(label, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms.setdefault(label(a, kw), []).append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    detect = timed(lambda a, kw: "detect", real[0])

    def detect_kept(self, img):
        out = detect(self, img)
        detections.append((img.shape, out))
        return out

    mtcnn.MTCNN.detect_faces = detect_kept
    face_recon.FaceReconNet.forward = timed(lambda a, kw: "recon", real[1])
    preprocess.align_crop = timed(lambda a, kw: f"crop{kw.get('output_size', 512)}", real[2])
    try:
        yield
    finally:
        mtcnn.MTCNN.detect_faces, face_recon.FaceReconNet.forward, preprocess.align_crop = real


def prep_photo_path(snap: str, photos: str, names: list, w: dict, root: str, smi: str) -> dict:
    """preprocess_in_the_wild -> dataset_tool -> ImageFolderDataset -> run_pti
    on the first crop with its label, K1 counted per step."""
    import copy
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import dataset_tool, preprocess_in_the_wild, run_pti
    from ide3d_tpu_torch.data.dataset import ImageFolderDataset
    from ide3d_tpu_torch.models.mtcnn import MTCNN

    ms, detections = {}, []
    with prep_stage_timer(ms, detections):
        t0 = time.perf_counter()
        preprocess_in_the_wild.main(["--indir", photos, "--mtcnn", w["mtcnn"],
                                     "--face-recon", w["face_recon"]])
        cli_s = time.perf_counter() - t0
    if [shape for shape, _ in detections] != [(1024, 1024, 3)]:
        raise RuntimeError(f"preprocess: detect_faces ran on {[s for s, _ in detections]}, "
                           "want the 1024² photo alone (the others' detections are cached)")
    found = detections[0][1]
    if not found:
        raise RuntimeError("preprocess: the CLI's cascade found no face on the 1024² photo")
    for r in found:
        if set(r) != {"box", "confidence", "keypoints"} or len(r["box"]) != 4 or \
                tuple(r["keypoints"]) != ("left_eye", "right_eye", "nose", "mouth_left", "mouth_right"):
            raise RuntimeError(f"preprocess: detect_faces result breaks its contract: {r}")
    wild = np.asarray(PIL.Image.open(os.path.join(photos, "wild.png")).convert("RGB"))
    cascade = cascade_card_vs_cpu(w["nets"], wild)
    # the cascade again on the same photo, warm (the CLI's call met each
    # pyramid level's shape for the first time)
    detector = MTCNN({k: copy.deepcopy(v).to("cuda").eval() for k, v in w["nets"].items()})
    for _ in range(PREP_WARM_DETECTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detector.detect_faces(wild)
        torch.cuda.synchronize()
        ms.setdefault("detect_warm", []).append((time.perf_counter() - t0) * 1e3)
    crop = os.path.join(photos, "crop")
    with open(os.path.join(crop, "dataset.json")) as f:
        labels = json.load(f)["labels"]
    got = [n for n, _ in labels]
    if got != [f"{n}.png" for n in names] + ["wild.png"]:
        raise RuntimeError(f"preprocess: dataset.json holds {got}")
    for n, lab in labels:
        lab = np.asarray(lab, np.float64)
        pose = lab[:16].reshape(4, 4)
        if not (lab.shape == (25,) and np.isfinite(lab).all()
                and abs(np.linalg.norm(pose[:3, 3]) - 2.7) < 1e-4
                and np.abs(pose[:3, :3] @ pose[:3, :3].T - np.eye(3)).max() < 1e-4):
            raise RuntimeError(f"preprocess: {n}'s label is not a radius-2.7 camera: {lab}")
        if np.asarray(PIL.Image.open(os.path.join(crop, n))).shape != (512, 512, 3):
            raise RuntimeError(f"preprocess: {n} is not a 512² RGB crop")

    dest = os.path.join(root, "crops.zip")
    dataset_tool.main(["--source", crop, "--dest", dest, "--resolution", "512"])
    ds = ImageFolderDataset(dest)
    if len(ds) != len(labels):
        raise RuntimeError(f"dataset_tool: {len(ds)} images read back, want {len(labels)}")
    img0, c0 = ds[0]
    want = np.asarray(labels[0][1], np.float32).copy()
    want[[1, 2, 5, 6, 9, 10]] *= -1  # the loader's OpenCV -> OpenGL flip
    if img0.shape != (512, 512, 3) or np.abs(c0 - want).max() > 1e-6:
        raise RuntimeError("dataset_tool: the zip does not read back to the crop and its label")

    # run_pti on the first crop with its label, in the dataset.json convention
    # (--opencv-labels applies the loader's flip; the c it renders at must be ds's)
    lab_path = os.path.join(root, "pti_labels.json")
    with open(lab_path, "w") as f:
        json.dump(labels[:1], f)
    meter = StepMeter()
    restore = _metered(meter)
    out = os.path.join(root, "pti_prep")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_pti.main(["--network", snap, "--images", os.path.join(crop, labels[0][0]), "--outdir",
                      out, "--labels", lab_path, "--opencv-labels", "--projector-steps",
                      str(PREP_STEPS), "--pti-steps", str(PREP_STEPS), "--lpips-threshold", "0",
                      "--device", "cuda"])
        torch.cuda.synchronize()
        pti_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        meter.mark("between")
    finally:
        restore()
    meter.check(PREP_LAUNCHES, "preprocess run_pti")
    name = os.path.splitext(labels[0][0])[0]
    c_used = np.load(os.path.join(out, f"{name}_label.npz"))["c"].reshape(-1)
    if np.abs(c_used - c0).max() > 1e-6:
        raise RuntimeError(f"run_pti rendered at {c_used}, the dataset's label is {c0}")
    ws = np.load(os.path.join(out, f"{name}.npz"))["ws"]
    if not np.isfinite(ws).all():
        raise RuntimeError("run_pti: non-finite pivot")
    launches = {k: meter.launches(k) for k in PREP_LAUNCHES}
    if [len(launches[k]) for k in PREP_LAUNCHES] != [PREP_STEPS, PREP_STEPS, 1]:
        raise RuntimeError(f"preprocess run_pti: steps counted {launches}")
    n_photos = PREP_PHOTOS + 1
    return {"stage_ms": {k: statistics.median(v) for k, v in ms.items()}, "stage_ms_each": ms,
            "cli_ms_per_photo": cli_s * 1e3 / n_photos, "found": len(found), "cascade": cascade,
            "crops": len(labels), "launches": launches,
            "step_ms": {k: meter.step_ms(k) for k in ("projector", "pti")}, "pti_s": pti_s,
            "peak_gib": {"run_pti": peak, **meter.peak}, "mse": meter.mse}


def tf_variables_g(G) -> dict:
    """A StyleGan2Generator's TF1 variables: the inverse of
    io/tf_legacy.convert_tf_generator_sd's name map and layout rules."""
    sd = {k: v.detach().cpu().numpy() for k, v in G.state_dict().items()}
    v = {"dlatent_avg": sd["mapping.w_avg"]}
    for i in range(G.cfg.mapping_num_layers):
        v[f"mapping/Dense{i}/weight"] = sd[f"mapping.fc{i}.weight"].T
        v[f"mapping/Dense{i}/bias"] = sd[f"mapping.fc{i}.bias"]
    v["synthesis/4x4/Const/const"] = sd["synthesis.b4.const"][None]

    def conv_w(a, flip=False):
        a = a.transpose(2, 3, 1, 0)  # [out, in, kh, kw] -> [kh, kw, in, out]
        return a[::-1, ::-1] if flip else a

    def layer(src, dst, noise_idx=None, flip=False):
        v[f"{dst}/weight"] = conv_w(sd[f"{src}.weight"], flip)
        v[f"{dst}/bias"] = sd[f"{src}.bias"]
        v[f"{dst}/mod_weight"] = sd[f"{src}.affine.weight"].T
        v[f"{dst}/mod_bias"] = sd[f"{src}.affine.bias"] - 1
        if noise_idx is not None:
            v[f"synthesis/noise{noise_idx}"] = sd[f"{src}.noise_const"][None, None]
            v[f"{dst}/noise_strength"] = sd[f"{src}.noise_strength"]

    layer("synthesis.b4.conv1", "synthesis/4x4/Conv", 0)
    layer("synthesis.b4.torgb", "synthesis/4x4/ToRGB")
    for res in G.block_resolutions[1:]:
        n = int(np.log2(res))
        layer(f"synthesis.b{res}.conv0", f"synthesis/{res}x{res}/Conv0_up", 2 * n - 5, flip=True)
        layer(f"synthesis.b{res}.conv1", f"synthesis/{res}x{res}/Conv1", 2 * n - 4)
        layer(f"synthesis.b{res}.torgb", f"synthesis/{res}x{res}/ToRGB")
    return v


def tf_variables_d(D) -> dict:
    """A Discriminator's TF1 variables (the inverse of convert_tf_discriminator_sd
    and of import_discriminator's (C, H, W) -> (H, W, C) column permutation)."""
    sd = {k: v.detach().cpu().numpy() for k, v in D.state_dict().items()}

    def conv_w(a):
        return a.transpose(2, 3, 1, 0)

    v = {}
    for res in D.block_resolutions:
        r = f"{res}x{res}"
        if f"b{res}.fromrgb.weight" in sd:
            v[f"{r}/FromRGB/weight"] = conv_w(sd[f"b{res}.fromrgb.weight"])
            v[f"{r}/FromRGB/bias"] = sd[f"b{res}.fromrgb.bias"]
        v[f"{r}/Conv0/weight"] = conv_w(sd[f"b{res}.conv0.weight"])
        v[f"{r}/Conv0/bias"] = sd[f"b{res}.conv0.bias"]
        v[f"{r}/Conv1_down/weight"] = conv_w(sd[f"b{res}.conv1.weight"])
        v[f"{r}/Conv1_down/bias"] = sd[f"b{res}.conv1.bias"]
        v[f"{r}/Skip/weight"] = conv_w(sd[f"b{res}.skip.weight"])
    v["4x4/Conv/weight"] = conv_w(sd["b4.conv.weight"])
    v["4x4/Conv/bias"] = sd["b4.conv.bias"]
    fcw = sd["b4.fc.weight"]  # [out, R*R*C], (H, W, C) order
    C = sd["b4.conv.bias"].shape[0]
    R = int(np.sqrt(fcw.shape[1] // C))
    v["4x4/Dense0/weight"] = fcw.reshape(-1, R, R, C).transpose(0, 3, 1, 2).reshape(fcw.shape[0], -1).T
    v["4x4/Dense0/bias"] = sd["b4.fc.bias"]
    v["Output/weight"] = sd["b4.out.weight"].T
    v["Output/bias"] = sd["b4.out.bias"]
    return v


def write_tf_pickle(path: str, G, D) -> None:
    """(G, D, Gs) as a TF1 StyleGAN2 pickle: dnnlib.tflib.network.Network
    objects (a class of that path made for the dump and removed after it) with
    version 4, static_kwargs and the variables in TF's layout; Gs is G."""
    import pickle
    import sys
    import types

    mods = ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")
    network = types.ModuleType(mods[2])
    Network = type("Network", (), {"__module__": mods[2], "__qualname__": "Network"})
    network.Network = Network
    for m in mods[:2]:
        sys.modules[m] = types.ModuleType(m)
    sys.modules[mods[2]] = network

    def net(variables, **static):
        n = Network()
        n.__dict__.update(version=4, name="G", static_kwargs=static, components={},
                          variables=sorted((k, np.array(a)) for k, a in variables.items()))
        return n

    g_static = dict(latent_size=G.cfg.z_dim, dlatent_size=G.cfg.w_dim, label_size=0,
                    resolution=G.cfg.img_resolution, num_channels=3,
                    fmap_base=G.cfg.channel_base // 2, fmap_max=G.cfg.channel_max,
                    mapping_layers=G.cfg.mapping_num_layers)
    d_static = dict(label_size=0, resolution=D.cfg.img_resolution, num_channels=3,
                    fmap_base=D.cfg.channel_base // 2, fmap_max=D.cfg.channel_max)
    try:
        gv = tf_variables_g(G)
        with open(path, "wb") as f:
            pickle.dump((net(gv, **g_static), net(tf_variables_d(D), **d_static), net(gv, **g_static)),
                        f, protocol=4)
    finally:
        for m in mods:
            del sys.modules[m]


def prep_tf_legacy(root: str, smi: str) -> dict:
    """A config-f StyleGan2Generator (1024², z = w = 512, 8 mapping layers,
    channel_base 32768, channel_max 512, no clamp, as TF pickles convert) and
    its Discriminator from seeded inits, written as a TF1 pickle and loaded
    by load_network_pkl(device="cuda"): parameters exactly the originals', a
    batch of 4 at 1024² fp32 and D's logits card against CPU."""
    import os

    from ide3d_tpu_torch.io import load_network_pkl
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.stylegan2 import StyleGan2Config, StyleGan2Generator

    G = StyleGan2Generator(StyleGan2Config(conv_clamp=None)).init(0).eval()
    D = Discriminator(DiscriminatorConfig(c_dim=0, img_resolution=1024, img_channels=3,
                                          dtype="float32")).init(1).eval()
    # Every tensor moved off its init (N(0, 0.01²) from one seed), so that one the
    # import leaves at the importer's own init cannot equal the original;
    # noise strengths at 0.05 first, so the noise maps count.
    draw = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for name, t in G.state_dict().items():
            if name.endswith("noise_strength"):
                t.fill_(0.05)
        for net in (G, D):
            for t in net.state_dict().values():
                t.add_(0.01 * torch.randn(t.shape, generator=draw))
    path = os.path.join(root, "stylegan2-config-f-tf.pkl")
    t0 = time.perf_counter()
    write_tf_pickle(path, G, D)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = load_network_pkl(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for key in ("G", "D", "G_ema"):
        if isinstance(out[key], Exception):
            raise RuntimeError(f"TF1 pickle: {key} did not convert: {out[key]!r}")
    Gc, rep = out["G_ema"]
    Dc, drep = out["D"]
    if Gc.cfg != G.cfg:
        raise RuntimeError(f"TF1 pickle: config {Gc.cfg} != {G.cfg}")
    for key, src in (("G", G), ("G_ema", G), ("D", D)):
        mod, r = out[key]
        a, b = mod.state_dict(), src.state_dict()
        if sorted(a) != sorted(b) or any(not torch.equal(a[k].cpu(), b[k]) for k in b):
            raise RuntimeError(f"TF1 pickle: {key}'s parameters are not the originals'")
        if r.skipped_source or r.imported != len(b):
            raise RuntimeError(f"TF1 pickle: {key} imported {r.imported} of {len(b)} tensors, "
                               f"left {r.skipped_source} unmapped")
    z = torch.as_tensor(np.random.RandomState(13).randn(TF_BATCH, 512), dtype=torch.float32)
    zc = z.cuda()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        img = Gc(zc)
        torch.cuda.synchronize()
        peak_g = torch.cuda.max_memory_allocated() / 2**30
        ref = G(z)
        g_err = scaled_err(img, ref)
        D32 = Discriminator(dataclasses.replace(Dc.cfg, dtype="float32")).to("cuda").eval()
        D32.load_state_dict(Dc.state_dict())
        torch.cuda.reset_peak_memory_stats()
        logits = D32(img, None)
        torch.cuda.synchronize()
        peak_d = torch.cuda.max_memory_allocated() / 2**30
        d_err = scaled_err(logits, D(ref, None))
        g_ms = event_median_ms(lambda: Gc(zc))
        d_ms = event_median_ms(lambda: D32(img, None))
    if g_err > NET_TOL or d_err > NET_TOL:
        raise RuntimeError(f"TF1 pickle: fp32 card vs cpu G {g_err:.3g}, D {d_err:.3g} "
                           f"(limit {NET_TOL:g} x scale)")
    if tuple(img.shape) != (TF_BATCH, 1024, 1024, 3) or tuple(logits.shape) != (TF_BATCH, 1):
        raise RuntimeError(f"TF1 pickle: shapes {tuple(img.shape)}, {tuple(logits.shape)}")
    return {"g_err": g_err, "d_err": d_err, "g_ms": g_ms, "d_ms": d_ms, "peak_gib":
            {"G": peak_g, "D": peak_d}, "write_s": write_s, "load_s": load_s,
            "imported": {"G_ema": rep.imported, "D": drep.imported},
            "pickle_mb": os.path.getsize(path) / 2**20}


def preprocess_launches(pre: dict, i: int) -> dict:
    """Phase 12's launches of K1 (i = 0) or its backward (i = 1) per step of
    the run_pti leg's loops and per _save_viz (all equal; checked)."""
    return {f"{k}_step" if k != "viz" else "save_viz": v[0][i]
            for k, v in pre["path"]["launches"].items()}


def phase_preprocess(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        write_snapshot(snap, GeneratorConfig(), seed=0)
        G = common.load_generator(snap, "cuda")
        photos, names = write_photos(G, root)
        del G
        w = write_prep_weights(root, photos)
        nets = prep_nets_card_vs_cpu(w, photos)
        path = prep_photo_path(snap, photos, names, w, root, smi)
        tf = prep_tf_legacy(root, smi)
    st, pre_bias, cas = path["stage_ms"], w["bias"], path["cascade"]
    med = {k: statistics.median(v) for k, v in path["step_ms"].items() if v}
    print(f"preprocess: fp32 card vs cpu, TF32 off, max abs err / max(1, |output|): "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in nets.items()})} (P-Net on the 1024² "
          f"photo's 615² level, R-/O-Net on 64 crops at 24²/48², FaceReconNet on 4 at 224² and "
          f"its 25-dim labels; limit {NET_TOL:g}); the cascade on the 1024² photo: {cas['found']} "
          f"faces, equal to the CPU's box stages fed the card's net outputs, net calls "
          f"{json.dumps(cas['calls'])}, the CPU's net inputs (max abs err, in [-1, 1]) "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in cas['inputs'].items()})} (limit "
          f"{RESIZE_TOL:g}) and its nets' outputs on them "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in cas['outputs'].items()})} against the "
          f"card's (limit {NET_TOL:g} x scale), probability "
          f"margins to the thresholds {json.dumps({k: float(f'{v:.3g}') for k, v in cas['margin'].items()})} "
          f"(need > {THRESH_MARGIN:g})", flush=True)
    print(f"preprocess: preprocess_in_the_wild on {PREP_PHOTOS} cached 512² renders + one 1024² "
          f"photo ({smi}): ms per call median detect (1024², the whole cascade on the card, "
          f"random-init nets with the class biases P-Net {pre_bias['pnet_bias']:.6f} "
          f"({pre_bias['pnet_pass']} positions pass), R-Net {MTCNN_CLASS_BIAS['rnet']:g}, O-Net "
          f"{MTCNN_CLASS_BIAS['onet']:g}; {path['found']} faces, the biggest cropped) "
          f"{st['detect']:.3f} at the CLI's first call, "
          f"{st['detect_warm']:.3f} warm ({[round(t, 3) for t in path['stage_ms_each']['detect_warm']]}), "
          f"FaceReconNet (224², batch 1, with the copy) {st['recon']:.3f}, align_crop 224² "
          f"{st['crop224']:.3f} / 512² {st['crop512']:.3f} (host); CLI wall "
          f"{path['cli_ms_per_photo']:.1f} ms a photo; {path['crops']} crops -> dataset_tool -> "
          f"ImageFolderDataset read back with the loader's label flip; run_pti on crop 0 with "
          f"its label (--opencv-labels, rendered at the dataset's c), {PREP_STEPS} + "
          f"{PREP_STEPS} steps at TF32 on: K1 (forward, backward) per projector step "
          f"{path['launches']['projector']}, per PTI step {path['launches']['pti']}, per "
          f"_save_viz {path['launches']['viz']}; event ms per step {json.dumps({k: [round(t, 3) for t in v] for k, v in path['step_ms'].items()})}; "
          f"MSE {[(lab, round(a, 5), round(b, 5)) for lab, a, b in path['mse']]}; peak GiB "
          f"{json.dumps({k: round(v, 3) for k, v in path['peak_gib'].items()})}; run_pti wall "
          f"{path['pti_s']:.1f} s", flush=True)
    print(f"preprocess: TF1 StyleGAN2 config-f (1024², {tf['pickle_mb']:.0f} MiB pickle, written "
          f"{tf['write_s']:.1f} s, load_network_pkl to cuda {tf['load_s']:.1f} s, "
          f"{tf['imported']} tensors imported) ({smi}): parameters equal the originals exactly; "
          f"fp32 card vs cpu, batch {TF_BATCH}: G {tf['g_err']:.3g}, D logits {tf['d_err']:.3g} x "
          f"scale (limit {NET_TOL:g}); event ms a batch G {tf['g_ms']:.3f}, D {tf['d_ms']:.3f}; "
          f"peak GiB {json.dumps({k: round(v, 3) for k, v in tf['peak_gib'].items()})}; phase 12 "
          f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    return {"nets": nets, "path": path, "tf": tf, "step_median_ms": med}


# Phase 13: the optional architectures at full width, bf16, each G from
# init(seed=0) written as a snapshot and read back by load_generator. Every G
# pass launches K1 once; a NADA step with geometry frozen (2, 0).
ARCH_RUNS = 5  # event-timed frames per batch size
ARCH_AVATAR_FRAMES = 8
ARCH_FID_ITEMS = 32  # cond_render FID: 4 G passes at batch 8
ARCH_FID_IMAGES = 32  # the labelled 512² set's size
SIGMA_MEDIAN = 13.0  # about the random flagship frame's median density


def counted(fn):
    """(fn(), (K1's launches, its backward's)), every count set to 0 just
    before the call and read just after it (the double backward's must be 0)."""
    zero_k1_counts()
    out = fn()
    return out, k1_launches("phase 13 path")


def arch_frames(G, label: str, seed: int = 0) -> dict:
    """gen_images.synth_views at batch 1 and 3 (the three yaws): a warm-up,
    then ARCH_RUNS event-timed frames each, K1 and its backward counted over
    them (one and none a frame), peak memory; one batch-3 frame's K1 inputs
    through kernel and plain (<= 1e-3)."""
    from ide3d_tpu_torch.apps import gen_images
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.render.renderer import RenderParams

    cfg = G.cfg
    rp = RenderParams(img_size=cfg.render_size, num_steps=96, hierarchical=True)
    cams = gen_images.yaw_cameras("cuda")
    c0 = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.inference_mode():
        ws = G.mapping(torch.as_tensor(np.random.RandomState(seed).randn(1, cfg.z_dim),
                                       dtype=torch.float32, device="cuda"), c0)
    out = {}
    for B, cam in ((1, cams[1:2]), (3, cams)):
        img, seg, _ = gen_images.synth_views(G, ws, cam, rp)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []

        def timed_frames():
            for _ in range(ARCH_RUNS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                frame = gen_images.synth_views(G, ws, cam, rp)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            return frame

        (img, seg, _), launches = counted(timed_frames)
        R = cfg.img_resolution
        if tuple(img.shape) != (B, R, R, 3) or tuple(seg.shape) != (B, R, R, 19):
            raise RuntimeError(f"{label}: frame shapes {tuple(img.shape)} {tuple(seg.shape)}")
        _check_finite(f"{label} frame", (img, seg))
        if launches != (ARCH_RUNS, 0):
            raise RuntimeError(f"{label}: K1 and its backward launched {launches} times for "
                               f"{ARCH_RUNS} frames")
        out[B] = {"ms": times, "median_ms": statistics.median(times),
                  "launches_per_frame": tuple(n / ARCH_RUNS for n in launches),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    captured = []

    def capture(*args, **kw):
        captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = capture
    try:
        gen_images.synth_views(G, ws, cams, rp)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = captured
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    _check_finite(f"{label} K1 and plain on a frame's inputs", (*got, *ref))
    err = max_err(got, ref)
    if err > 1e-3:
        raise RuntimeError(f"{label}: K1 vs plain on a frame's inputs: max abs err {err}")
    # At random init the hybrid's densities are far below 0, so nearly every
    # weight is exactly 0 in fp32 and kernel and plain agree bit for bit; hold
    # K1 also on these inputs with the density moved to the flagship's median.
    sigma = torch.cat([args[1][..., -1], args[3][..., -1]], 2).float()
    moved, shift = list(args), SIGMA_MEDIAN - float(sigma.median())
    for i in (1, 3):
        moved[i] = args[i].clone()
        moved[i][..., -1] += shift
    with torch.inference_mode():
        got, ref2 = ray_march.sort_integrate(*moved, **kw), ray_march.sort_integrate_plain(*moved, **kw)
    _check_finite(f"{label} K1 and plain on the moved density", (*got, *ref2))
    err_moved = max_err(got, ref2)
    if err_moved > 1e-3:
        raise RuntimeError(f"{label}: K1 vs plain at the moved density: max abs err {err_moved}")
    out.update(k1_err=err, k1_err_moved=err_moved, sigma_shift=shift, ws=ws,
               frame=lambda: gen_images.synth_views(G, ws, cams, rp))
    return out


def op_ms(mod, name: str, frame) -> tuple:
    """The calls of `mod.<name>` in one run of frame(), then each call alone
    on its own inputs, event-timed (median of ARCH_RUNS, the card idle
    before each): (calls, summed ms)."""
    fn, calls = getattr(mod, name), []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(mod, name, recorded)
    try:
        frame()
    finally:
        setattr(mod, name, fn)
    with torch.inference_mode():
        return len(calls), sum(event_median_ms(lambda a=a, kw=kw: fn(*a, **kw), ARCH_RUNS)
                               for a, kw in calls)


FLRELU_BATCH = 8  # the video path's chunk
FLRELU_TOL = 1e-5  # fp32 kernel against the fp32 plain op, x max|out| (the card tests' rule)
BF16_ROUNDING = 2.0**-8  # one bf16 rounding of max|out|
FP32_CUDA_CORE_FLOPS_PER_MS = 67e9  # H100 SXM, fp32 on the CUDA cores, 67 TFLOP/s


def flrelu_counts(fn) -> tuple:
    """(fn(), (filtered_lrelu's kernel launches, its plain calls)), both set to
    0 just before the call and read just after it."""
    from ide3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu

    filtered_lrelu.launches = filtered_lrelu.plain = 0
    out = fn()
    torch.cuda.synchronize()
    return out, (filtered_lrelu.launches, filtered_lrelu.plain)


def flrelu_bytes(x, kw, out) -> int:
    """Bytes one call must move: x, the bias and the filters read once, the
    output written once."""
    return sum(t.numel() * t.element_size() for t in (x, kw["b"], kw["fu"], kw["fd"], out)
               if t is not None)


def flrelu_fir_flops(x, kw) -> int:
    """The call's polyphase FIR FLOPs (2 a multiply-add): rows then columns up,
    taps / up a pixel of the upsampled grid (no product with an inserted
    zero), rows then columns down, taps a pixel."""
    fu, fd, up, down = kw["fu"], kw["fd"], kw["up"], kw["down"]
    if fu is None and fd is None:
        return 0
    N, C, n, _ = x.shape
    tu, td = (1 if f is None else f.numel() for f in (fu, fd))
    px0, px1 = kw["padding"][:2]
    u = n * up + px0 + px1 - tu + 1
    o = (u - td) // down + 1
    per_phase = -(-tu // up)
    return 2 * N * C * (n * u * per_phase + u * u * per_phase + u * o * td + o * o * td)


def arch_flrelu(G) -> dict:
    """The SG3 G's filtered_lrelu at the video path's shapes: two bf16 frame
    batches of FLRELU_BATCH (random latents, the front camera), each with the
    counters set to 0 just before it (9 launches and no plain call each), the
    first's 9 calls recorded. On each call's card tensors: the kernel against
    filtered_lrelu_plain in fp32 (<= FLRELU_TOL x max|out|) and in bf16 (both
    against the fp32 plain op on the same bf16 input: the kernel's error at
    most the plain bf16 op's plus BF16_ROUNDING x max|out|); then each call
    alone, event-timed (eager_ms), plain, fused, fused, plain, and the
    kernel's device time from a CUDA graph of 20 calls; its bytes over
    3.35 TB/s and FIR FLOPs over the fp32 CUDA-core rate."""
    from ide3d_tpu_torch.models import layers_sg3
    from ide3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    B = FLRELU_BATCH
    z = torch.as_tensor(np.random.RandomState(1).randn(B, G.cfg.z_dim), dtype=torch.float32,
                        device="cuda")
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None].repeat(B, 1)
    calls = []

    def record(x, fu, fd, b, **kw):
        if len(calls) < 9:
            calls.append((x.clone(), dict(kw, fu=fu, fd=fd, b=b.clone())))
        return filtered_lrelu(x, fu, fd, b, **kw)

    counts = []
    layers_sg3.filtered_lrelu = record
    try:
        with torch.inference_mode():
            ws = G.mapping(z, c)
            for _ in range(2):
                counts.append(flrelu_counts(lambda: G.synthesis(ws, c))[1])
    finally:
        layers_sg3.filtered_lrelu = filtered_lrelu
    if counts != [(9, 0)] * 2 or len(calls) != 9:
        raise RuntimeError(f"sg3 B={B}: filtered_lrelu (launches, plain) {counts} a frame batch, "
                           f"{len(calls)} calls recorded; want (9, 0) and 9")
    rows = []
    for x, kw in calls:
        kw = dict(kw, padding=tuple(kw["padding"]))
        xf, kwf = x.float(), dict(kw, b=kw["b"].float())
        with torch.inference_mode():
            got32, want32 = filtered_lrelu(xf, **kwf), filtered_lrelu_plain(xf, **kwf)
            got, plain = filtered_lrelu(x, **kw), filtered_lrelu_plain(x, **kw)
        _check_finite("filtered_lrelu on a frame's inputs", (got32, want32, got, plain))
        scale = float(want32.abs().max())
        err32, err, err_plain = (float((a.float() - want32).abs().max()) for a in (got32, got, plain))
        if err32 > FLRELU_TOL * scale or err > err_plain + BF16_ROUNDING * scale:
            raise RuntimeError(f"filtered_lrelu kernel vs plain at x {tuple(x.shape)} up {kw['up']} "
                               f"down {kw['down']}: fp32 err {err32}, bf16 err {err} (plain bf16 "
                               f"{err_plain}) at max|out| {scale}")
        with torch.inference_mode():
            def run_plain():
                return filtered_lrelu_plain(x, **kw)

            def run_fused():
                return filtered_lrelu(x, **kw)

            p1, _ = eager_ms(run_plain)
            f1, h1 = eager_ms(run_fused)
            f2, h2 = eager_ms(run_fused)
            p2, _ = eager_ms(run_plain)
            fg = graph_ms([run_fused], 20)
        nbytes = flrelu_bytes(x, kw, got)
        rows.append({"shape": list(x.shape), "up": kw["up"], "down": kw["down"],
                     "plain_ms": [p1, p2], "eager_ms": [f1, f2], "host_ms": [h1, h2], "ms": fg,
                     "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_MS,
                     "fir_bound_ms": flrelu_fir_flops(x, kw) / FP32_CUDA_CORE_FLOPS_PER_MS,
                     "err_fp32": err32 / scale, "err_bf16": err / scale,
                     "err_plain_bf16": err_plain / scale})
    total = {k: sum(r[k] for r in rows) for k in ("ms", "bytes", "bound_ms", "fir_bound_ms")}
    total.update({k: sum(statistics.mean(r[k]) for r in rows)
                  for k in ("plain_ms", "eager_ms", "host_ms")})
    return {"batch": B, "launches": counts, "calls": rows, **total,
            "max_abs_err": max(r["err_fp32"] for r in rows),
            "bf16_err": max(r["err_bf16"] for r in rows),
            "plain_bf16_err": max(r["err_plain_bf16"] for r in rows)}


def arch_sg3(snap: str, cfg) -> dict:
    """Phase 13's SG3 G (`GeneratorConfig(sr_arch="sg3")` read back from the
    snapshot at `snap`): its frames (arch_frames), each filtered_lrelu call
    of a batch-3 frame alone on the kernel (op_ms), arch_flrelu at the video
    path's batch, and the fp32 copy card vs CPU."""
    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.models import layers_sg3
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    G = common.load_generator(snap, "cuda")
    if G.cfg != cfg or G.synthesis.sg3_sr is None:
        raise RuntimeError(f"sg3 snapshot read back as {G.cfg}")
    sg3 = arch_frames(G, "sg3")
    sg3["filtered_lrelu"] = op_ms(layers_sg3, "filtered_lrelu", sg3.pop("frame"))
    del sg3["ws"]
    sg3["flrelu"] = arch_flrelu(G)
    del G
    sg3["fp32"] = fp32_card_vs_cpu(GeneratorConfig(sr_arch="sg3", dtype="float32"), 0, "sg3")
    return sg3


def flrelu_line(f: dict) -> str:
    return (f"filtered_lrelu kernel at B={f['batch']} bf16, the stack's 9 calls: (launches, plain) "
            f"a frame batch {f['launches']}; each call alone, event ms plain / fused / fused / plain "
            f"{[[round(v, 4) for v in (*r['plain_ms'][:1], *r['eager_ms'], r['plain_ms'][1])] for r in f['calls']]}; "
            f"a chunk: plain {f['plain_ms']:.3f} ms, fused {f['eager_ms']:.4f} ms (graph "
            f"{f['ms']:.4f}, host {f['host_ms']:.4f}), ratio {f['eager_ms'] / f['plain_ms']:.4f}; "
            f"bytes {f['bytes'] / 1e9:.4f} GB, bound {f['bound_ms']:.4f} ms ({100 * f['bound_ms'] / f['ms']:.1f}% "
            f"of the graph time), FIR bound {f['fir_bound_ms']:.4f} ms; fp32 err "
            f"{f['max_abs_err']:.3g} x max|out| (limit {FLRELU_TOL:g}), bf16 err {f['bf16_err']:.3g} "
            f"(plain bf16 {f['plain_bf16_err']:.3g}) x max|out|")


def flrelu_entry(sg3: dict) -> dict:
    """The `kernels` line's entry for the fused filtered_lrelu (phase 13's SG3 G)."""
    f = sg3["flrelu"]
    return {
        "name": "filtered_lrelu",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/filtered_lrelu.cu",
        "replaces": None,
        "launches": sum(n[0] for n in f["launches"]),
        "plain_calls": sum(n[1] for n in f["launches"]),
        "max_abs_err": f["max_abs_err"],
        "max_abs_err_is": "fp32, relative to max|out|",
        "bf16_err": f["bf16_err"],
        "plain_bf16_err": f["plain_bf16_err"],
        "ms": f["ms"],
        "plain_ms": f["plain_ms"],
        "eager_ms": f["eager_ms"],
        "host_ms": f["host_ms"],
        "bound_ms": f["bound_ms"],
        "bound_by": "bytes",
        "fir_bound_ms": f["fir_bound_ms"],
        "library_ms": None,
        "bytes": f["bytes"],
        "bound_share": f["bound_ms"] / f["ms"],
        "batch": f["batch"],
        "calls": f["calls"],
        "b3_frame_calls_ms": sg3["filtered_lrelu"],
    }


def phase13_sg3_alone() -> dict:
    """Phase 13's SG3 G on its own (device, build):
    `python3 -c "import chip_smoke as cs; cs.phase13_sg3_alone()"`. Prints the
    arch line's SG3 part and a `kernels` line with the filtered_lrelu entry."""
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    smi = phase_device()
    phase_build()
    cfg = GeneratorConfig(sr_arch="sg3")
    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "sg3")
        write_snapshot(snap, cfg, seed=0)
        sg3 = arch_sg3(snap, cfg)
    print(f"arch: sg3 ({smi.splitlines()[0]}): {sg3_line(sg3)}", flush=True)
    print(json.dumps({"kernels": [flrelu_entry(sg3)]}))
    return sg3


def sg3_line(sg3: dict) -> str:
    return (f"sg3 GeneratorConfig(sr_arch=sg3) bf16: frames {json.dumps(arch_frame_rows(sg3))}, "
            f"K1 vs plain {sg3['k1_err']:.3g}, filtered_lrelu (the fused kernel) in a batch-3 frame: "
            f"{sg3['filtered_lrelu'][0]} calls, {sg3['filtered_lrelu'][1]:.3f} ms alone; "
            f"{flrelu_line(sg3['flrelu'])}; fp32 cuda vs cpu {sg3['fp32']['err']} at scale "
            f"{sg3['fp32']['scale']}")


def arch_frame_rows(r: dict) -> dict:
    return {f"batch_{B}": {"median_ms": round(r[B]["median_ms"], 3),
                           "range_ms": [round(min(r[B]["ms"]), 3), round(max(r[B]["ms"]), 3)],
                           "peak_gib": round(r[B]["peak_gib"], 3)} for B in (1, 3)}


def _u8(img: torch.Tensor) -> np.ndarray:
    return ((img + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy().astype(np.int32)


def arch_painter(G) -> dict:
    """One Painter round (phase 6's requests) through PainterWebApp.handle on
    the hybrid G, after a warm-up round: route wall ms, K1 and plane_table
    per request (the plane cache carries the volume, so the flagship's counts
    hold). Every frame the session renders in the round, against G.synthesis
    of its ws and c with the planes and the volume made anew: within 1 uint8
    level."""
    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.apps.web_ui import PainterWebApp
    from ide3d_tpu_torch.models.encoder import HybridEncoder

    R, n_geo = G.cfg.img_resolution, G.synthesis.num_ws_geo
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      dtype=G.cfg.dtype).init(seed=1)
    app = PainterWebApp(PainterSession(G=G, E=E.to("cuda").eval(), device="cuda"))
    S = G.synthesis
    counts, frames = {"planes": 0}, []
    plane_table, forward = S.plane_table, S.forward

    def counted_planes(*args, **kw):
        counts["planes"] += 1
        return plane_table(*args, **kw)

    def recorded(ws, c, *args, **kw):
        out = forward(ws, c, *args, **kw)
        if kw.get("table") is not None:
            frames.append((ws.clone(), c.clone(), (out[0] if isinstance(out, tuple) else out).clone()))
        return out

    S.plane_table = counted_planes
    try:
        painter_round(app, counts, check=True)
        torch.cuda.synchronize()
        S.forward = recorded
        rows, _ = painter_round(app, counts, check=False)
    finally:
        del S.plane_table
        S.__dict__.pop("forward", None)
    gap = 0
    with torch.inference_mode():
        for ws, c, img in frames:
            gap = max(gap, int(np.abs(_u8(img) - _u8(S(ws, c))).max()))
    if gap > 1 or not frames:
        raise RuntimeError(f"hybrid painter: {len(frames)} cached-table frames, uint8 gap to "
                           f"G.synthesis {gap} (limit 1)")
    return {"rows": [(r, round(ms, 3), k1, pl, bwd) for r, ms, k1, pl, bwd in rows],
            "frames": len(frames), "gap": gap,
            "per_round": (sum(r[2] for r in rows), sum(r[4] for r in rows))}


def arch_nada(G) -> dict:
    """One NADA step on the hybrid G at batch 2 with geometry frozen, a fixed
    random projection of the pooled image standing in for CLIP: K1 (2, 0),
    the feature volume out of the optimizer, without gradient and
    bit-identical, the superres moved; event ms of the step."""
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.train import nada

    gen = torch.Generator().manual_seed(0)
    proj = torch.randn(3, 64, generator=gen).cuda()
    tdir = torch.randn(64, generator=gen).cuda()
    z = torch.randn(2, G.cfg.z_dim, generator=gen).cuda()
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None].expand(2, -1)
    G_train = nada.init_nada(G)
    fv = G_train.synthesis.feature_volume
    before = {k: v.clone() for k, v in G_train.state_dict().items()}
    step = nada.make_nada_step(G_train, G, lambda img: img.float().mean(dim=(1, 2)) @ proj, tdir)
    step(z, c, torch.Generator(device="cuda").manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss, launches = counted(lambda: step(z, c, torch.Generator(device="cuda").manual_seed(2)))
    end.record()
    end.synchronize()
    after = G_train.state_dict()
    fv_same = all(torch.equal(after[k], before[k]) for k in after if ".feature_volume." in f".{k}")
    sr_moved = any(not torch.equal(after[k], before[k]) for k in after if k.startswith("synthesis.b"))
    no_grad = all(not p.requires_grad and p.grad is None for p in fv.parameters())
    if launches != (2, 0) or not (fv_same and sr_moved and no_grad) or not torch.isfinite(loss):
        raise RuntimeError(f"hybrid NADA step: K1 {launches} (want (2, 0)), volume frozen "
                           f"{fv_same}, no gradient {no_grad}, superres moved {sr_moved}, loss {loss}")
    return {"launches": launches, "ms": start.elapsed_time(end), "loss": float(loss)}


def arch_fine_steps(G, ws) -> dict:
    """The flagship G's three-yaw batch of `ws` at num_steps 64, fine_steps
    128 beside 96 + 96 (event ms, medians of ARCH_RUNS, in turns 96, 64, 64,
    96); K1 and its backward counted over one 64 + 128 frame, and K1 on that
    frame's inputs against plain (<= 1e-3)."""
    from ide3d_tpu_torch.apps import gen_images
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.renderer import RenderParams

    cams = gen_images.yaw_cameras("cuda")
    rps = {"96+96": RenderParams(num_steps=96), "64+128": RenderParams(num_steps=64, fine_steps=128)}
    ms, halves = {}, []

    def capture(*args, **kw):
        halves.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    for k in ("96+96", "64+128", "64+128", "96+96"):
        gen_images.synth_views(G, ws, cams, rps[k])
        ms.setdefault(k, []).append(event_median_ms(
            lambda rp=rps[k]: gen_images.synth_views(G, ws, cams, rp), ARCH_RUNS))
    renderer.sort_integrate = capture
    try:
        (img, *_), launches = counted(lambda: gen_images.synth_views(G, ws, cams, rps["64+128"]))
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = halves
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    _check_finite("fine_steps frame, K1 and plain", (img, *got, *ref))
    err = max_err(got, ref)
    if (args[1].shape[2], args[3].shape[2]) != (64, 128) or err > 1e-3 or launches != (1, 0):
        raise RuntimeError(f"fine_steps: K1 halves {args[1].shape[2]}+{args[3].shape[2]}, "
                           f"max abs err vs plain {err}, K1 and its backward {launches}")
    return {"ms": ms, "k1_err": err, "halves": (64, 128), "launches": launches}


def arch_encoder(snap: str, root: str) -> dict:
    """The encoder G: G(cond_img=<its own render>) at batch 1 with the camera
    from its yaw/pitch head (event ms); infer_face_animation_avatar
    --style-image (that render) for ARCH_AVATAR_FRAMES frames, K1 once a
    frame; metric_main.calc_metric fid with cond_render on 32 labelled 512²
    images (Inception, deterministic init, batch 8), K1 once a G pass. K1
    and its backward are counted on each of the three."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import common, infer_face_animation_avatar
    from ide3d_tpu_torch.data.dataset import ImageFolderDataset
    from ide3d_tpu_torch.metrics import calc_metric, make_detector
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    G = common.load_generator(snap, "cuda")
    R = G.cfg.img_resolution
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.inference_mode():
        own = G(torch.as_tensor(np.random.RandomState(0).randn(1, 512), dtype=torch.float32,
                                device="cuda"), c)
        G(cond_img=own)
        frame, cond_launches = counted(lambda: G(cond_img=own))
        cond_ms = event_median_ms(lambda: G(cond_img=own), ARCH_RUNS)
        ws, cam = G.encode(own)
    _check_finite("cond_img frame", [frame, ws, cam])
    if tuple(frame.shape) != (1, R, R, 3) or cond_launches != (1, 0):
        raise RuntimeError(f"cond_img frame {tuple(frame.shape)}, K1 {cond_launches}")

    style = os.path.join(root, "style.png")
    PIL.Image.fromarray(_u8(own[0]).astype(np.uint8)).save(style)
    t0 = time.perf_counter()
    _, avatar_launches = counted(lambda: infer_face_animation_avatar.main(
        ["--network", snap, "--style-image", style, "--frames", str(ARCH_AVATAR_FRAMES),
         "--output", os.path.join(root, "avatar.mp4"), "--device", "cuda"]))
    avatar_s = time.perf_counter() - t0
    if avatar_launches != (ARCH_AVATAR_FRAMES, 0):
        raise RuntimeError(f"avatar: K1 {avatar_launches} for {ARCH_AVATAR_FRAMES} frames")

    imgs, _ = write_dataset(os.path.join(root, "data"), ARCH_FID_IMAGES, R)
    det = make_detector("inception", device="cuda")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        rec, fid_launches = counted(lambda: calc_metric(
            "fid", G=G, dataset=ImageFolderDataset(imgs, resolution=R), detector=det,
            num_items=ARCH_FID_ITEMS, batch_size=METRIC_BATCH, cond_render=True, device="cuda"))
    if not np.isfinite(rec["results"]["fid"]) or fid_launches != (ARCH_FID_ITEMS // METRIC_BATCH, 0):
        raise RuntimeError(f"cond_render fid {rec['results']}, K1 {fid_launches}")
    return {"cond_ms": cond_ms, "cond_launches": cond_launches, "cam": cam[0].tolist(),
            "avatar_s": avatar_s, "avatar_launches": avatar_launches,
            "fid": rec["results"]["fid"], "fid_s": rec["total_time"], "fid_launches": fid_launches}


def phase_arch(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.render import renderer

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        snaps = {k: os.path.join(root, k) for k in ("hybrid", "sg3", "encoder")}
        cfgs = {"hybrid": GeneratorConfig(use_feature_volume=True),
                "sg3": GeneratorConfig(sr_arch="sg3"), "encoder": GeneratorConfig(use_encoder=True)}
        for k, path in snaps.items():
            write_snapshot(path, cfgs[k], seed=0)

        G = common.load_generator(snaps["hybrid"], "cuda")
        if G.cfg != cfgs["hybrid"] or G.synthesis.feature_volume is None:
            raise RuntimeError(f"hybrid snapshot read back as {G.cfg}")
        hyb = arch_frames(G, "hybrid")
        # The flagship in the same call: its frames, then the batch-3 frame of
        # each G in turns (flagship, hybrid, hybrid, flagship, twice).
        G_flag = Ide3dGenerator(GeneratorConfig()).init(seed=0).to("cuda").eval()
        flag = arch_frames(G_flag, "flagship")
        ab = {"flagship": [], "hybrid": []}
        for k in ("flagship", "hybrid", "hybrid", "flagship") * 2:
            ab[k].append(event_median_ms((flag if k == "flagship" else hyb)["frame"], ARCH_RUNS))
        with torch.inference_mode():
            ws = hyb.pop("ws")
            hyb["volume_ms"] = event_median_ms(lambda: G.synthesis.volume(ws), ARCH_RUNS)
        hyb["grid_sample_3d"] = op_ms(renderer, "grid_sample_3d", hyb.pop("frame"))
        hyb["fp32"] = fp32_card_vs_cpu(GeneratorConfig(use_feature_volume=True, dtype="float32"), 0,
                                       "hybrid")
        pnt = arch_painter(G)
        nad = arch_nada(G)
        del G
        fine = arch_fine_steps(G_flag, flag.pop("ws"))
        del G_flag, flag["frame"]

        sg3 = arch_sg3(snaps["sg3"], cfgs["sg3"])
        enc = arch_encoder(snaps["encoder"], root)

    print(f"arch: hybrid GeneratorConfig(use_feature_volume=True) bf16 96+96 ({smi}): "
          f"frames {json.dumps(arch_frame_rows(hyb))} (event ms over {ARCH_RUNS}, K1 once a frame), the "
          f"volume alone {hyb['volume_ms']:.3f} ms; K1 vs plain on a frame's inputs "
          f"{hyb['k1_err']:.3g}, with the density moved to a median of {SIGMA_MEDIAN:g} "
          f"(by {hyb['sigma_shift']:+.4g}; the flagship's by {flag['sigma_shift']:+.4g}) "
          f"{hyb['k1_err_moved']:.3g}; grid_sample_3d in a "
          f"batch-3 frame: {hyb['grid_sample_3d'][0]} calls, {hyb['grid_sample_3d'][1]:.3f} ms alone; "
          f"fp32 cuda vs cpu {hyb['fp32']['err']} at scale "
          f"{hyb['fp32']['scale']} (limit 3e-5 x scale); Painter round (wall ms, K1, "
          f"plane_table) {pnt['rows']}, {pnt['frames']} cached-table frames within "
          f"{pnt['gap']} uint8 level of G.synthesis; NADA step (geometry frozen, batch 2) "
          f"{nad['ms']:.3f} ms, K1 {nad['launches']}, the volume without gradient", flush=True)
    print(f"arch: flagship GeneratorConfig() frames in this call {json.dumps(arch_frame_rows(flag))}; "
          f"batch-3 frames in turns, event ms (medians of {ARCH_RUNS}) flagship "
          f"{[round(t, 3) for t in ab['flagship']]}, hybrid {[round(t, 3) for t in ab['hybrid']]}; "
          f"fine_steps on it, the three-yaw batch: event ms {json.dumps({k: [round(t, 3) for t in v] for k, v in fine['ms'].items()})} (in turns 96, 64, 64, 96); "
          f"K1 at halves 64+128 vs plain {fine['k1_err']:.3g}; {sg3_line(sg3)}", flush=True)
    print(f"arch: encoder GeneratorConfig(use_encoder=True): G(cond_img=its render) "
          f"{enc['cond_ms']:.3f} ms (camera head {[round(v, 4) for v in enc['cam']]}), K1 "
          f"{enc['cond_launches']}; infer_face_animation_avatar --style-image "
          f"{ARCH_AVATAR_FRAMES} frames in {enc['avatar_s']:.2f} s, K1 and its backward "
          f"{enc['avatar_launches']}; "
          f"calc_metric fid cond_render ({ARCH_FID_ITEMS} items, {ARCH_FID_IMAGES} labelled "
          f"512² images, Inception deterministic init, TF32 on) {enc['fid']:.6g} in "
          f"{enc['fid_s']:.1f} s, K1 {enc['fid_launches']}; phase 13 wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"hybrid": hyb, "sg3": sg3, "painter": pnt, "nada": nad, "fine": fine, "encoder": enc,
            "flagship": flag, "ab": ab,
            "k1_err": max(hyb["k1_err"], sg3["k1_err"], fine["k1_err"], flag["k1_err"],
                          hyb["k1_err_moved"], sg3["k1_err_moved"], flag["k1_err_moved"])}


def arch_launches(arch: dict, i: int) -> dict:
    """Phase 13's launches of K1 (i = 0) or its backward (i = 1) per pass of
    each of its paths, as counted there."""
    enc = arch["encoder"]
    return {**{f"{k}_frame_b{B}": arch[k][B]["launches_per_frame"][i]
               for k in ("hybrid", "sg3") for B in (1, 3)},
            "fine_64_128_frame": arch["fine"]["launches"][i],
            "cond_img_frame": enc["cond_launches"][i],
            "avatar_frame": enc["avatar_launches"][i] / ARCH_AVATAR_FRAMES,
            "cond_render_fid_per_batch": enc["fid_launches"][i] * METRIC_BATCH / ARCH_FID_ITEMS,
            "hybrid_painter_round": arch["painter"]["per_round"][i],
            "hybrid_nada_step": arch["nada"]["launches"][i]}


PARITY_STEPS = 5  # flagship steps of phase 14 at PL_INTERVAL 4: PL on steps 0 and 4
PARITY_TURNS = 2  # PL / plain and wavelet / bilinear step pairs timed in turns
# K1 (forward, backward, double backward) launches per flagship train step:
# a PL step renders twice (the G loss, the PL pass), runs the backward once
# for the G loss, once inside the PL pass's create_graph gradient and once
# where the second pass reaches the PL render's K1 node, and the double
# backward once where it reaches the first pass's backward node.
PARITY_LAUNCHES = {"pl": (2, 3, 1), "plain": (1, 1, 0)}


def k1_double_backward_bytes(args, cot, gg) -> int:
    """Bytes K1's double backward must move: the backward's inputs and gg read
    once, gradients as large as the values and the cotangents written once."""
    read = sum(t.numel() * t.element_size() for t in (*args, *cot, *gg) if t is not None)
    return read + sum(t.numel() * t.element_size() for t in (args[1], args[3], *cot))


def group_err(got, ref) -> float:
    """The larger of rel_err over the value gradients and over the cotangent
    gradients (each group against its own max|ref|)."""
    return max(rel_err(got[:2], ref[:2]), rel_err(got[2:], ref[2:]))


def misaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte boundary."""
    n = x.numel() * x.element_size()
    buf = torch.empty(n + 64, dtype=torch.uint8, device=x.device)
    off = (4 - buf.data_ptr()) % 16
    return buf[off:off + n].view(x.dtype).view(x.shape).copy_(x)


def parity_double_backward(smi: str) -> dict:
    """K1's double backward against autograd through its plain version at
    B=4, every option, fp32 and bf16 values, sorted and unsorted halves, and
    on the streamed plan (a misaligned gg_a); then timed at the training
    render's layout, staged and streamed (the first design), each plan read
    back from the kernel's C++."""
    from ide3d_tpu_torch.ops.ray_march import (double_backward_plan, sort_integrate_double_backward,
                                               sort_integrate_double_backward_plain)

    gen = torch.Generator().manual_seed(14)
    errs, plans = {}, {}

    def check(name, args, cot, gg, kw, tol):
        got = sort_integrate_double_backward(*args, *cot, *gg, **kw)
        ref = sort_integrate_double_backward_plain(*args, *cot, *gg, **kw)
        torch.cuda.synchronize()
        _check_finite(f"K1 double backward {name}", [g.float() for g in got])
        err = group_err(got, ref)
        if err > tol or any(g.dtype != r.dtype for g, r in zip(got, ref)):
            raise RuntimeError(f"K1 double backward vs plain ({name}): max abs err / max|grad| "
                               f"{err} > {tol}")
        errs[name] = err
        plans.setdefault(double_backward_plan(*args, *cot, *gg, **kw), []).append(name)

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        for sorted_halves in (False, True):
            args = k1_inputs(gen, dtype, B=4, sorted_halves=sorted_halves)
            cot = _k1_cotangents(gen, args)
            gg = [torch.randn(v.shape, generator=gen).to("cuda", dtype) for v in (args[1], args[3])]
            for opts in K1_OPTIONS:
                name = f"{str(dtype).split('.')[-1]} {'sorted' if sorted_halves else 'unsorted'} " \
                       f"{','.join(opts) or 'softplus'}"
                check(name, args, cot, gg, _k1_options(opts, args, gen), tol)
                if dtype == torch.bfloat16 and not sorted_halves:  # the streamed plan
                    check(f"{name} misaligned gg_a", args, cot, [misaligned_copy(gg[0]), gg[1]],
                          _k1_options(opts, args, gen), tol)
            del args, cot, gg
    if "streamed" not in plans or "staged" not in plans:
        raise RuntimeError(f"K1 double backward: checked plans {sorted(plans)}, want staged and "
                           f"streamed")

    sets = [(a, c, [torch.randn(v.shape, generator=gen).to("cuda", v.dtype) for v in (a[1], a[3])])
            for a, c in training_k1_sets(gen)]
    streamed = [(a, c, [misaligned_copy(g[0]), g[1]]) for a, c, g in sets]
    plan = double_backward_plan(*sets[0][0], *sets[0][1], *sets[0][2])
    streamed_plan = double_backward_plan(*streamed[0][0], *streamed[0][1], *streamed[0][2])
    if (plan, streamed_plan) != ("staged", "streamed"):
        raise RuntimeError(f"K1 double backward at the training layout: plans {plan}, "
                           f"{streamed_plan}")
    dbl = [lambda s=s: sort_integrate_double_backward(*s[0], *s[1], *s[2]) for s in sets]
    dbl_streamed = [lambda s=s: sort_integrate_double_backward(*s[0], *s[1], *s[2])
                    for s in streamed]
    t_dbl, t_streamed = [], []
    for _ in range(2):  # in turns
        t_dbl.append(graph_ms(dbl, 10))
        t_streamed.append(graph_ms(dbl_streamed, 4))
    plain = [event_median_ms(lambda s=s: sort_integrate_double_backward_plain(*s[0], *s[1], *s[2]),
                             runs=5) for s in sets]
    nbytes = k1_double_backward_bytes(*sets[0])
    out = {"max_abs_err": max(errs.values()), "errs": errs, "ms": min(t_dbl), "plain_ms": min(plain),
           "bound_ms": nbytes / HBM_BYTES_PER_MS, "bytes": nbytes, "plan": plan,
           "streamed_ms": min(t_streamed)}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"parity: K1 double backward bf16 B=4 R=4096 S=96+96 C=51 (coarse sorted, fine "
          f"unsorted): {plan} plan {t_dbl[0]:.4f}/{t_dbl[1]:.4f} ms, {nbytes} B, bound "
          f"{out['bound_ms'] * 1e3:.1f} us ({100 * out['bound_share']:.1f}% of it); the same "
          f"with a misaligned gg_a, {streamed_plan} plan (the first design) {t_streamed[0]:.4f}/"
          f"{t_streamed[1]:.4f} ms; plain double backward (autograd, event ms) "
          f"{[round(p, 4) for p in plain]} ({smi}); vs plain, max abs err / max|grad| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (limits fp32 1e-4, bf16 "
          f"1e-2); plans of the checks {json.dumps(plans)}", flush=True)
    return out


def parity_pl_card_vs_cpu() -> dict:
    """The tiny fp32 preset's PL penalty, mean length and G gradients at given
    ws, y and pl_mean (const noise, the deterministic render), card (K1, its
    backward and double backward) against CPU (plain)."""
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.train import gan

    rng = np.random.RandomState(14)
    res = {}
    for dev in ("cpu", "cuda"):
        G, _ = _tiny_gan(dev)
        ws = torch.from_numpy(rng.randn(2, G.num_ws, 512).astype(np.float32) * 0.5)
        y = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32) / 32)
        rng = np.random.RandomState(14)  # the same draws on both devices
        c = torch.as_tensor(CANONICAL_POSE_25)[None].repeat(2, 1).to(dev)
        zero_k1_counts()
        pen, lengths = gan.pl_penalty(G, ws.to(dev).requires_grad_(), c, torch.tensor(0.5, device=dev),
                                      None, y=y.to(dev))
        grads = [g for g in torch.autograd.grad(pen, list(G.parameters()), allow_unused=True)
                 if g is not None]
        res[dev] = {"values": [pen.detach(), lengths.detach().mean()], "g": grads,
                    "launches": k1_counts()}
    err = {"values": rel_err([v.cpu() for v in res["cuda"]["values"]], res["cpu"]["values"]),
           "g": rel_err([g.cpu() for g in res["cuda"]["g"]], res["cpu"]["g"])}
    print(f"parity: tiny fp32 G, PL penalty and mean length "
          f"{[round(float(v), 6) for v in res['cuda']['values']]}, card (K1 launches (forward, "
          f"backward, double backward) {res['cuda']['launches']}) vs CPU (plain): max abs err / "
          f"max|x| {json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})} (limit 1e-4)",
          flush=True)
    if max(err.values()) > 1e-4:
        raise RuntimeError(f"parity: PL card vs CPU {err}")
    if res["cuda"]["launches"] != (1, 2, 1):
        raise RuntimeError(f"parity: tiny PL K1 launches {res['cuda']['launches']}, want (1, 2, 1)")
    return err


def _timed_step(step, state, batch, gen, ada_p, at: int):
    """One step of `step` at state.step = `at`: (stats, event ms, K1 counts,
    peak GiB), every count set to 0 just before it."""
    state.step = at
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_k1_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, s = step(state, batch, gen, ada_p)
    end.record()
    end.synchronize()
    stats = {k: float(v) for k, v in s.items()}
    if not all(np.isfinite(v) for v in stats.values()):
        raise RuntimeError(f"parity step at {at}: non-finite stats {stats}")
    return stats, start.elapsed_time(end), k1_counts(), torch.cuda.max_memory_allocated() / 2**30


def parity_full_width(smi: str) -> dict:
    """The flagship at batch 4, bf16: PARITY_STEPS steps with pl_weight 2 (PL
    on steps 0 and 4, R1 on step 0), each step's K1 launches exact; PL and
    plain steps in turns; then wavelet_aa against the bilinear warp, an R1
    step and a plain step of each, in turns."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.train import augment, gan

    B, cfg = 4, GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / B, pl_weight=2.0)
    G = Ide3dGenerator(cfg).init(seed=0).cuda()
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg))).init(1).cuda()
    state = gan.init_gan_state(G, D, tcfg)
    step = gan.make_gan_train_step(tcfg)
    batch = synthetic_batch(B, cfg.img_resolution, seed=14)
    gen = torch.Generator(device="cuda").manual_seed(14)

    runs = [_timed_step(step, state, batch, gen, TRAIN_ADA_P, i) for i in range(PARITY_STEPS)]
    pl_means, read = [], {"pl": set(), "plain": set()}  # the K1 counts read per kind of step
    for i, (s, _, n, _) in enumerate(runs):
        kind = "pl" if i % gan.PL_INTERVAL == 0 else "plain"
        read[kind].add(n)
        if n != PARITY_LAUNCHES[kind]:
            raise RuntimeError(f"parity step {i} ({kind}): K1 launches {n}, want {PARITY_LAUNCHES[kind]}")
        if (s["pl_penalty"] > 0) != (kind == "pl"):
            raise RuntimeError(f"parity step {i}: pl_penalty {s['pl_penalty']} off its interval")
    if not float(state.pl_mean) > 0:
        raise RuntimeError(f"parity: pl_mean {float(state.pl_mean)} did not move")
    pl_means.append(float(state.pl_mean))
    # PL (step 4, 8) and plain (5, 9) steps in turns; no R1 at these steps.
    turns = {"pl": [], "plain": []}
    for k in range(PARITY_TURNS):
        for kind, at in (("pl", gan.PL_INTERVAL * (k + 1)), ("plain", gan.PL_INTERVAL * (k + 1) + 1)):
            s, ms, n, peak = _timed_step(step, state, batch, gen, TRAIN_ADA_P, at)
            read[kind].add(n)
            if n != PARITY_LAUNCHES[kind]:
                raise RuntimeError(f"parity {kind} step: K1 launches {n}")
            turns[kind].append((ms, peak))
    pl_means.append(float(state.pl_mean))

    # wavelet_aa against the bilinear warp at ada_p 0.2: an R1 step (at 0) and
    # a plain step (at 1) of each, in turns, on the same state.
    steps = {"wavelet": gan.make_gan_train_step(dataclasses.replace(
        tcfg, pl_weight=0.0, aug=augment.AugmentConfig(wavelet_aa=True))),
        "bilinear": gan.make_gan_train_step(dataclasses.replace(tcfg, pl_weight=0.0))}
    warp = {f"{w}_{k}": [] for w in steps for k in ("r1", "plain")}
    for _ in range(PARITY_TURNS):
        for w, fn in steps.items():
            for k, at in (("r1", 0), ("plain", 1)):
                s, ms, n, peak = _timed_step(fn, state, batch, gen, TRAIN_ADA_P, at)
                if (s["r1_penalty"] > 0) != (k == "r1") or n != (1, 1, 0):
                    raise RuntimeError(f"parity {w} {k} step: R1 {s['r1_penalty']}, K1 {n}")
                warp[f"{w}_{k}"].append((ms, peak))
    print(f"parity: GeneratorConfig() bf16 + Discriminator(img_channels=25) bf16, batch 4, ada_p "
          f"{TRAIN_ADA_P}, pl_weight 2, pl_interval {gan.PL_INTERVAL} ({smi}): steps "
          f"0-{PARITY_STEPS - 1} ms "
          f"{[round(r[1], 3) for r in runs]} (step 0 with R1 and the first calls), K1 (forward, "
          f"backward, double backward) per step {[r[2] for r in runs]}, peaks GiB "
          f"{[round(r[3], 3) for r in runs]}, pl_penalty {[round(r[0]['pl_penalty'], 5) for r in runs]}, "
          f"pl_mean {pl_means}; in turns, PL step ms / peak {turns['pl']}, plain {turns['plain']}; "
          f"wavelet_aa vs bilinear, R1 and plain steps in turns (ms, peak GiB): "
          f"{json.dumps({k: [(round(a, 3), round(b, 3)) for a, b in v] for k, v in warp.items()})}",
          flush=True)
    (pl_read,), (plain_read,) = read["pl"], read["plain"]  # one reading each, checked above
    return {"launches": [r[2] for r in runs], "step_ms": [r[1] for r in runs],
            "pl_step_launches": pl_read, "plain_step_launches": plain_read,
            "pl_ms": [t for t, _ in turns["pl"]], "plain_ms": [t for t, _ in turns["plain"]],
            "pl_peak_gib": max(p for _, p in turns["pl"]),
            "plain_peak_gib": max(p for _, p in turns["plain"]),
            "warp": {k: [t for t, _ in v] for k, v in warp.items()},
            "warp_peak_gib": {k: max(p for _, p in v) for k, v in warp.items()},
            "pl_means": pl_means}


def parity_entry_point() -> dict:
    """tools/torch_make_synthetic_dataset.py writes 8 sphere-head views at
    512²; apps.train_gan.main --pl-weight 2 --wavelet-aa for 2 steps on them,
    then --resume of its snapshot-final, which restores every state dict."""
    import os
    import tempfile

    from ide3d_tpu_torch.apps import train_gan
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "sphere")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "tools/torch_make_synthetic_dataset.py", "--out", data,
                        "--identities", "4", "--views", "2", "--resolution", "512"],
                       check=True, capture_output=True, text=True, timeout=300)
        data_s = time.perf_counter() - t0
        common = ["--data", os.path.join(data, "img"), "--seg", os.path.join(data, "seg"),
                  "--preset", "full", "--batch", "4", "--kimg", "0.008", "--pl-weight", "2",
                  "--wavelet-aa", "--fixed-ada-p", str(TRAIN_ADA_P), "--device", "cuda"]
        t0 = time.perf_counter()
        zero_k1_counts()
        first = train_gan.main(common + ["--outdir", os.path.join(root, "run")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = k1_counts()
        snap = os.path.join(root, "run", "snapshot-final")
        saved, meta = load_checkpoint(snap)
        if first.step != 2 or meta["step"] != 2 or not float(first.pl_mean) > 0:
            raise RuntimeError(f"train_gan --pl-weight 2: step {first.step}, pl_mean "
                               f"{float(first.pl_mean)}")
        resumed = train_gan.main(common + ["--outdir", os.path.join(root, "resumed"),
                                           "--resume", snap])
        for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
            _same_state(saved[name], getattr(resumed, name).state_dict(), name)
        _same_state(saved["pl_mean"], resumed.pl_mean, "pl_mean")
        if resumed.step != 2:
            raise RuntimeError(f"train_gan --resume: step {resumed.step}, want 2")
    # 2 steps: a PL step and a plain one, plus the grid's G_ema render (K1 once)
    want = tuple(a + b for a, b in zip(PARITY_LAUNCHES["pl"], PARITY_LAUNCHES["plain"]))
    want = (want[0] + 1, want[1], want[2])
    if launches != want:
        raise RuntimeError(f"train_gan --pl-weight 2: K1 launches {launches}, want {want}")
    print(f"parity: tools/torch_make_synthetic_dataset.py 8 views at 512² in {data_s:.1f} s; "
          f"apps.train_gan.main --preset full --batch 4 --kimg 0.008 --pl-weight 2 --wavelet-aa on "
          f"them: 2 steps in {run_s:.1f} s (G and D init, grid, snapshot included), K1 (forward, "
          f"backward, double backward) {launches}, pl_mean {float(first.pl_mean):.6g}; --resume of "
          f"snapshot-final restored G, D, G_ema, opt_g, opt_d, pl_mean, step 2", flush=True)
    return {"run_s": run_s, "launches": launches}


def phase_parity(smi: str) -> dict:
    t0 = time.perf_counter()
    k = parity_double_backward(smi)
    e = parity_pl_card_vs_cpu()
    f = parity_full_width(smi)
    a = parity_entry_point()
    print(f"parity: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"k1_double_backward": k, "card_vs_cpu": e, "full": f, "app": a}


TOOLS_EVAL_N, TOOLS_EVAL_BATCH = 16, 8  # torch_eval_trained_encoder: 2 batches of 8
TOOLS_VIEWS = (4, 4)  # identities x views of the labelled 512² set
TOOLS_ITEM = "00001_2"
# K1 (forward, backward, double backward) of each tool run: one forward a G
# pass. The demo renders the recon at its own pose and at the front (2), the
# edit's two passes (2) and the yaw sweep from the plane cache (3);
# import_and_verify renders 4 goldens and 4 gen_images batches of 3 yaws.
TOOLS_LAUNCHES = {"eval_trained_encoder": (2, 0, 0), "painter_trained_demo": (7, 0, 0),
                  "import_and_verify": (8, 0, 0)}
REF_MOVE_STD = 0.01  # every parameter and w_avg of the pickled G moved by N(0, 0.01²)


def ref_layout_state(G) -> dict:
    """The state dict of a reference-layout pickle of a vb_ref_compat G, under
    the names io/torch_import reads: the mapping and the vb/b blocks under
    their own names, the renderer's decoder as an unnamed torch MLP
    (synthesis.renderer.mlp.<leaf>.weight [out, in], .bias), which the
    importer recovers by its unique shapes."""
    sd = {}
    for name, t in G.state_dict().items():
        t = t.detach().float().cpu().clone()
        if name.startswith("synthesis.renderer."):
            leaf = name.rsplit(".", 1)[1]
            kind = "weight" if t.ndim == 2 else "bias"
            sd[f"synthesis.renderer.mlp.{leaf}.{kind}"] = t.t().contiguous() if t.ndim == 2 else t
        else:
            sd[name] = t
    return sd


def write_ref_pickle(path: str, sd: dict) -> None:
    """{"G_ema": module tree} of plain dicts ({_parameters, _buffers,
    _modules}, as a pickled nn.Module's state reads) holding `sd`'s tensors."""
    import pickle

    def node():
        return {"_parameters": {}, "_buffers": {}, "_modules": {}}

    root = node()
    for name, t in sd.items():
        *mods, leaf = name.split(".")
        cur = root
        for m in mods:
            cur = cur["_modules"].setdefault(m, node())
        cur["_parameters"][leaf] = t
    with open(path, "wb") as f:
        pickle.dump({"G_ema": root}, f)


def tools_eval(snap: str, enc: str, data: str, smi: str) -> dict:
    """torch_eval_trained_encoder --n 16 --batch 8 on the card: its JSON, K1
    counted over the run, the first batch's K1 inputs held to plain."""
    import contextlib as ctx
    import io

    import torch_eval_trained_encoder
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    buf = io.StringIO()
    renderer.sort_integrate = capture
    try:
        t0 = time.perf_counter()
        zero_k1_counts()
        with ctx.redirect_stdout(buf):
            torch_eval_trained_encoder.main(["--network", snap, "--encoder", enc, "--data", data,
                                             "--n", str(TOOLS_EVAL_N),
                                             "--batch", str(TOOLS_EVAL_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1_counts()
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if launches != TOOLS_LAUNCHES["eval_trained_encoder"]:
        raise RuntimeError(f"eval_trained_encoder: K1 launches {launches}, "
                           f"want {TOOLS_LAUNCHES['eval_trained_encoder']}")
    if rec["n"] != TOOLS_EVAL_N or not all(np.isfinite(rec[k]) for k in ("rgb_l2", "seg_miou",
                                                                          "ws_spread")):
        raise RuntimeError(f"eval_trained_encoder: {rec}")
    ((args, kw),) = captured
    if args[1].shape[0] != TOOLS_EVAL_BATCH:
        raise RuntimeError(f"eval_trained_encoder: K1 at B={args[1].shape[0]}")
    with torch.inference_mode():
        err = max_err(ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw))
    if err > 1e-3:
        raise RuntimeError(f"eval_trained_encoder: K1 vs plain on its batch-8 inputs {err} > 1e-3")
    print(f"tools: torch_eval_trained_encoder --n {TOOLS_EVAL_N} --batch {TOOLS_EVAL_BATCH} on the "
          f"flagship bf16 snapshot and HybridEncoder(512, 10, 8).init(1): {json.dumps(rec)} in "
          f"{wall:.1f} s, K1 (forward, backward, double backward) {launches}; K1 on its batch's "
          f"inputs (vals {args[1].dtype}, {tuple(args[1].shape)}+{tuple(args[3].shape)}) vs plain "
          f"max abs err {err:.3g} ({smi})", flush=True)
    return {"launches": launches, "k1_err": err, "wall_s": wall, "json": rec}


def tools_demo(snap: str, enc: str, data: str, root: str) -> dict:
    """torch_painter_trained_demo on the encoder's inversion: K1 counted, the
    three PNGs written, the front recon within 1 uint8 level of G.synthesis."""
    import PIL.Image

    import torch_painter_trained_demo
    from ide3d_tpu_torch.apps.common import load_generator
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import build_encoder, load_image, load_mask
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.utils.seg import mask2onehot

    out = os.path.join(root, "demo")
    t0 = time.perf_counter()
    zero_k1_counts()
    torch_painter_trained_demo.main(["--network", snap, "--encoder", enc, "--data", data,
                                     "--item", TOOLS_ITEM, "--outdir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_counts()
    if launches != TOOLS_LAUNCHES["painter_trained_demo"]:
        raise RuntimeError(f"painter_trained_demo: K1 launches {launches}, "
                           f"want {TOOLS_LAUNCHES['painter_trained_demo']}")
    G = load_generator(snap, "cuda")
    E = build_encoder(G, enc, "cuda")
    R = G.cfg.img_resolution
    img = load_image(os.path.join(data, "img", TOOLS_ITEM + ".png"), R)
    mask = load_mask(os.path.join(data, "seg", TOOLS_ITEM + ".png"), R)
    with torch.inference_mode():
        seg_pm = mask2onehot(torch.from_numpy(mask).cuda()[None]) * 2.0 - 1.0
        ws = E(torch.from_numpy(img).cuda()[None], seg_pm) + G.mapping.w_avg[None, None]
        front = _u8(G.synthesis(ws, torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]))[0]
    recon = np.asarray(PIL.Image.open(os.path.join(out, "painter_trained_recon.png")), np.int32)
    gap = int(np.abs(recon[:, 2 * R: 3 * R] - front).max())
    if gap > 1:
        raise RuntimeError(f"painter_trained_demo: front recon {gap} levels off G.synthesis")
    for name in ("recon", "edit", "edit_mask"):
        if not os.path.exists(os.path.join(out, f"painter_trained_{name}.png")):
            raise RuntimeError(f"painter_trained_demo: no painter_trained_{name}.png")
    print(f"tools: torch_painter_trained_demo --item {TOOLS_ITEM} (encoder inversion, hair "
          f"dilation, edit, yaws -0.4/0/0.4) in {wall:.1f} s: K1 {launches}, the 3 PNGs written, "
          f"front recon {gap} uint8 levels off G.synthesis", flush=True)
    return {"launches": launches, "wall_s": wall, "front_gap": gap}


def tools_import(root: str) -> dict:
    """torch_import_and_verify on a reference-layout pickle of the
    reference-compat G at full width (seeded, every parameter and w_avg moved by
    N(0, 0.01²)): rc 0 with every tensor imported exactly, K1 counted;
    --check-golden against its own first run; a second pickle whose decoder
    has two tensors of one shape returns 2."""
    import contextlib as ctx
    import io

    import torch_import_and_verify
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator

    cfg = GeneratorConfig(vb_ref_compat=True, raw_head="slice")
    G = Ide3dGenerator(cfg).init(seed=15)
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for t in [*G.parameters(), G.mapping.w_avg]:
            t.add_(torch.randn(t.shape, generator=gen) * REF_MOVE_STD)
    sd = ref_layout_state(G)
    want = {k: v.detach().float().cpu() for k, v in G.state_dict().items()}
    del G
    pkl = os.path.join(root, "ref.pkl")
    write_ref_pickle(pkl, sd)
    runs, rcs, buf = {}, {}, io.StringIO()
    for label, extra in (("first", []), ("check_golden", ["--check-golden", os.path.join(
            root, "iv_first", "golden_import.npz")])):
        t0 = time.perf_counter()
        zero_k1_counts()
        with ctx.redirect_stdout(buf):
            rcs[label] = torch_import_and_verify.main([pkl, "--outdir", os.path.join(root, f"iv_{label}"),
                                                       *extra])
        torch.cuda.synchronize()
        runs[label] = (time.perf_counter() - t0, k1_counts())
        if rcs[label] != 0 or runs[label][1] != TOOLS_LAUNCHES["import_and_verify"]:
            raise RuntimeError(f"import_and_verify ({label}): rc {rcs[label]}, K1 {runs[label][1]}, "
                               f"want 0, {TOOLS_LAUNCHES['import_and_verify']}\n"
                               f"{buf.getvalue()[-3000:]}")
    log = buf.getvalue()
    if "0 source tensors unmapped" not in log or "0 destination leaves left initialized" not in log:
        raise RuntimeError(f"import_and_verify: not every tensor imported:\n{log[-3000:]}")
    saved, _ = load_checkpoint(os.path.join(root, "iv_first", "ckpt"))
    diff = [k for k, v in want.items() if not torch.equal(saved["G_ema"][k].float(), v)]
    if sorted(saved["G_ema"]) != sorted(want) or diff:
        raise RuntimeError(f"import_and_verify: imported G differs from the pickled one at {diff[:5]}")
    golden = np.load(os.path.join(root, "iv_first", "golden_import.npz"))
    if not all(np.isfinite(golden[k]).all() for k in golden.files):
        raise RuntimeError("import_and_verify: non-finite goldens")
    # The ambiguous pickle: the decoder's first bias doubled under another name.
    amb = dict(sd)
    b1 = next(k for k in sd if k.startswith("synthesis.renderer.") and k.endswith(".bias"))
    amb["synthesis.renderer.extra.bias"] = sd[b1].clone()
    write_ref_pickle(pkl, amb)
    with ctx.redirect_stdout(io.StringIO()):
        rcs["ambiguous"] = torch_import_and_verify.main([pkl, "--outdir", os.path.join(root, "iv_amb")])
    if rcs["ambiguous"] != 2:
        raise RuntimeError(f"import_and_verify on the ambiguous pickle: rc {rcs['ambiguous']}, want 2")
    print(f"tools: torch_import_and_verify on a reference-layout pickle of "
          f"GeneratorConfig(vb_ref_compat=True, raw_head='slice') (init(15), moved by N(0, "
          f"{REF_MOVE_STD}²), {len(sd)} tensors, {os.path.getsize(pkl) >> 20} MiB): rc "
          f"{rcs['first']} in {runs['first'][0]:.1f} s, every tensor imported and equal, goldens "
          f"finite, K1 {runs['first'][1]}; --check-golden rc {rcs['check_golden']} in "
          f"{runs['check_golden'][0]:.1f} s; duplicated decoder shape rc {rcs['ambiguous']}",
          flush=True)
    return {"launches": runs["first"][1], "wall_s": runs["first"][0], "rcs": rcs}


def phase_tools(smi: str) -> dict:
    import tempfile

    from ide3d_tpu_torch.io.checkpoint import save_checkpoint
    from ide3d_tpu_torch.models.encoder import HybridEncoder
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        snap, enc, data = (os.path.join(root, d) for d in ("g", "e", "sphere"))
        write_snapshot(snap, GeneratorConfig(), seed=0)
        save_checkpoint(enc, {"E": HybridEncoder(512, 10, 8).init(seed=1).state_dict()})
        subprocess.run([sys.executable, "tools/torch_make_synthetic_dataset.py", "--out", data,
                        "--identities", str(TOOLS_VIEWS[0]), "--views", str(TOOLS_VIEWS[1]),
                        "--resolution", "512"], check=True, capture_output=True, text=True,
                       timeout=300)
        inputs_s = time.perf_counter() - t0
        ev = tools_eval(snap, enc, data, smi)
        demo = tools_demo(snap, enc, data, root)
        imp = tools_import(root)
    wall = time.perf_counter() - t0
    print(f"tools: phase 15 in {wall:.1f} s (inputs {inputs_s:.1f} s)", flush=True)
    return {"eval": ev, "demo": demo, "import": imp, "wall_s": wall}


# Phase 16: data parallelism. The ranks are processes of their own, started
# with torch.multiprocessing.spawn at world size torch.cuda.device_count()
# over NCCL; each runs the paths as torchrun's ranks run them (RANK,
# WORLD_SIZE, LOCAL_RANK and a fresh MASTER_PORT a call), writes its
# readings to a JSON file, and the parent checks them.
PAR_FRAME_SEEDS = (0, 1, 2)
PAR_ADA_P = 0.2
PAR_TURNS = ("plain", "dp", "dp", "plain") * 2
PAR_METRIC_ITEMS, PAR_METRIC_BATCH = 64, 8
# World 2 on one card against one process, the tiny fp32 step: Adam's moments
# (the averaged gradients) within GLOO_MOMENT_TOL of each tensor's max (the
# ranks' batch of 2 against one process's 4 sums in another order: 5.4e-5 read
# on an H100; on the CPU the same gaps fall to float64 rounding in float64,
# tests/test_torch_parallel_float64.py). The parameters, from equal weights:
# their gap must be the gap of Adam's first updates made of the two runs' own
# moments, within 1e-5 of each tensor's max, for every element (a step moves
# an element by about lr * sign(g), and by lr * g / (|g| + eps) near eps, so
# a moment gap moves the elements whose |g| lies within it, or near eps, by up
# to 2 lr: 1.2e-4 of max read where the raw gap was held; PR 15's call 4).
GLOO_MOMENT_TOL = 5e-4


def _adam_first_update(opt, p) -> torch.Tensor:
    """Adam's first update of p (torch's formula, float64) from its moments."""
    group, st = opt.param_groups[0], opt.state[p]
    (b1, b2), eps = group["betas"], group["eps"]
    m, v = st["exp_avg"].double() / (1 - b1), st["exp_avg_sq"].double() / (1 - b2)
    return group["lr"] * m / (v.sqrt() + eps)


@torch.no_grad()
def step_gap(a, b) -> dict:
    """Two GanTrainStates after one step from equal weights: the largest gap
    of Adam's moments, of the parameters, and of the parameters less the gap
    of Adam's first updates of each state's own moments, each relative to its
    tensor's max."""
    mom = raw = par = 0.0
    for net, opt in (("G", "opt_g"), ("D", "opt_d")):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for pa, pb in zip(getattr(a, net).parameters(), getattr(b, net).parameters()):
            for k in ("exp_avg", "exp_avg_sq"):
                ref = ob.state[pb][k].abs().max().clamp_min(1e-30)
                mom = max(mom, float((oa.state[pa][k] - ob.state[pb][k]).abs().max() / ref))
            scale = pb.abs().max().clamp_min(1e-30)
            gap = pa.double() - pb.double()
            raw = max(raw, float(gap.abs().max() / scale))
            unexplained = gap + _adam_first_update(oa, pa) - _adam_first_update(ob, pb)
            par = max(par, float(unexplained.abs().max() / scale))
    return {"moments": mom, "params_raw": raw, "params": par}


def _par_env(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _captured_k1():
    """(capture list, spy): the spy keeps the first K1 call's inputs."""
    from ide3d_tpu_torch.ops import ray_march

    kept = []

    def spy(*args, **kw):
        if not kept:
            kept.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    return kept, spy


def par_frames(group, snaps: dict) -> dict:
    """The ray-sharded frame of each snapshot's G at B=1 and 3 against
    G.synthesis on the same card: max abs err, uint8 levels, this rank's K1
    launches and the shape of its K1 input, that input through kernel and
    plain, and the frame's event ms beside G.synthesis's (B=3)."""
    from ide3d_tpu_torch.apps import common, gen_images
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.parallel import mesh
    from ide3d_tpu_torch.parallel.render import make_ray_sharded_frame
    from ide3d_tpu_torch.render import renderer

    out = {}
    cams = gen_images.yaw_cameras(group.device)
    for name, snap in snaps.items():
        G = common.load_generator(snap, group.device)
        mesh.replicate(group, G)
        frame = make_ray_sharded_frame(G.synthesis, group)
        for B in (1, 3):
            z = torch.as_tensor(np.stack([np.random.RandomState(s).randn(G.z_dim)
                                          for s in PAR_FRAME_SEEDS[:B]]), dtype=torch.float32,
                                device=group.device)
            c = cams[:B].contiguous()
            with torch.inference_mode():
                ws = G.mapping(z, c)
            kept, spy = _captured_k1()
            renderer.sort_integrate = spy
            try:
                torch.cuda.synchronize()
                zero_k1_counts()
                img, seg = frame(ws, c)
                torch.cuda.synchronize()
                launches = k1_counts()
            finally:
                renderer.sort_integrate = ray_march.sort_integrate
            with torch.inference_mode():
                ref_img, ref_seg = G.synthesis(ws, c, return_seg=True)
            _check_finite(f"sharded frame {name} B={B}", [img, seg])
            u8 = lambda x: torch.round((x + 1) * 127.5).clamp(0, 255).to(torch.int32)
            (args, kw), = kept
            with torch.inference_mode():
                k1_err = max_err(ray_march.sort_integrate(*args, **kw),
                                 ray_march.sort_integrate_plain(*args, **kw))
            rec = {"err": max(max_err([img], [ref_img]), max_err([seg], [ref_seg])),
                   "levels": int((u8(img) - u8(ref_img)).abs().max()),
                   "launches": launches, "k1_shape": list(args[1].shape), "k1_err": k1_err}
            del args, kw, kept
            if B == 3:
                rec["ms"] = event_median_ms(lambda: frame(ws, c))
                with torch.inference_mode():
                    rec["synthesis_ms"] = event_median_ms(
                        lambda: G.synthesis(ws, c, return_seg=True))
            out[f"{name}_b{B}"] = rec
        del G, frame
        torch.cuda.empty_cache()
    return out


def par_step_ms(group) -> dict:
    """The flagship train step at global batch 4 (bf16, ada_p 0.2, no R1):
    make_gan_train_step without a group (the plain step, on this rank's
    process alone: no collective, no flat gradient buffer, no row gather, as
    before the data-parallel layer) and with the group, on one state, in
    turns (PAR_TURNS; every rank runs each data-parallel turn, rank 0 the
    plain ones): event ms and K1 counts of each."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.parallel import mesh
    from ide3d_tpu_torch.train import gan

    B, cfg = 4, GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / B)
    G = Ide3dGenerator(cfg).init(seed=0).to(group.device)
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg)))
    state = gan.init_gan_state(G, D.init(1).to(group.device), tcfg)
    steps = {"plain": gan.make_gan_train_step(tcfg), "dp": gan.make_gan_train_step(tcfg, group)}
    full = synthetic_batch(B, cfg.img_resolution, seed=0)
    batches = {"plain": full, "dp": mesh.shard_batch(group, full)}
    gen = torch.Generator(device=group.device).manual_seed(0)
    ms = {"plain": [], "dp": []}
    launches = {}
    for i, kind in enumerate(("plain", "dp") + PAR_TURNS):
        if kind == "plain" and not group.is_main:
            continue
        _, t, counts, _ = _timed_step(steps[kind], state, batches[kind], gen, PAR_ADA_P, at=1 + i)
        if i >= 2:
            ms[kind].append(t)
        launches[kind] = counts
    del state, G, D
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches}


def par_rank(index: int, world: int, port0: int, root: str, paths: dict) -> None:
    """One rank of phase 16: every path under the group, readings to
    root/rank<index>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ide3d_tpu_torch.apps import calc_metrics, common, gen_images, train_gan, \
        train_hybrid_encoder
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint
    from ide3d_tpu_torch.parallel import mesh

    port = iter(range(port0, port0 + 100))
    res = {}

    def under_group(fn, *args):
        _par_env(index, world, next(port))
        return mesh.launch(fn, world, "cuda", *args)

    t0 = time.perf_counter()
    res["frames"] = under_group(par_frames, {"flagship": paths["flagship"],
                                             "hybrid": paths["hybrid"]})
    res["frames_s"] = time.perf_counter() - t0
    from ide3d_tpu_torch.apps import gen_videos

    # gen_videos: phase 8's flagship video, each chunk split over the ranks.
    written, real = [], common.write_video
    common.write_video = lambda path, frames, fps=24: written.append(frames) or real(
        path, frames, fps)
    try:
        _par_env(index, world, next(port))
        torch.cuda.synchronize()
        zero_k1_counts()
        t0 = time.perf_counter()
        vid = gen_videos.main(["--network", paths["flagship"], *VIDEO_ARGS, "--image-mode",
                               "image_seg", "--output", os.path.join(root, "par.mp4")])
        res["video"] = {"launches": k1_counts(), "s": time.perf_counter() - t0,
                        "ms_per_frame": vid["ms_per_frame"] if vid else None}
    finally:
        common.write_video = real
    if index == 0:
        np.save(os.path.join(root, "par_video.npy"), np.stack(written[0]))

    # train_gan --pl-weight 2: 2 steps, a snapshot, and --resume of it.
    common_args = ["--data", paths["img"], "--seg", paths["seg"], "--preset", "full", "--batch",
                   "4", "--kimg", "0.008", "--pl-weight", "2", "--fixed-ada-p", str(PAR_ADA_P),
                   "--device", "cuda"]
    run, resumed = os.path.join(root, "run"), os.path.join(root, "resumed")
    _par_env(index, world, next(port))
    torch.cuda.synchronize()
    zero_k1_counts()
    t0 = time.perf_counter()
    first = train_gan.main(common_args + ["--outdir", run])
    torch.cuda.synchronize()
    res["train_gan"] = {"launches": k1_counts(), "s": time.perf_counter() - t0}
    _par_env(index, world, next(port))
    again = train_gan.main(common_args + ["--outdir", resumed, "--resume",
                                          os.path.join(run, "snapshot-final")])
    if index == 0:
        saved, meta = load_checkpoint(os.path.join(run, "snapshot-final"))
        for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
            _same_state(saved[name], getattr(again, name).state_dict(), name)
            _same_state(getattr(first, name).state_dict(), getattr(again, name).state_dict(), name)
        if first.step != 2 or again.step != 2 or meta["step"] != 2 or not float(first.pl_mean) > 0:
            raise RuntimeError(f"train_gan: steps {first.step}, {again.step}, pl_mean "
                               f"{float(first.pl_mean)}")
        res["train_gan"]["pl_mean"] = float(first.pl_mean)
    del first, again
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res["step"] = under_group(par_step_ms)
    res["step"]["s"] = time.perf_counter() - t0

    # train_hybrid_encoder: 2 steps, both branches, no loss networks.
    _par_env(index, world, next(port))
    torch.cuda.synchronize()
    zero_k1_counts()
    t0 = time.perf_counter()
    enc = train_hybrid_encoder.main(["--network", paths["flagship"], "--data", paths["img"],
                                     "--seg", paths["seg"], "--outdir",
                                     os.path.join(root, "enc"), "--batch", "4", "--max-steps",
                                     "2", "--snap", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    res["encoder"] = {"launches": k1_counts(), "s": time.perf_counter() - t0,
                      "step": enc.step if enc is not None else None}
    del enc
    torch.cuda.empty_cache()

    # calc_metrics fid on 64 items with --mesh-devices world.
    _par_env(index, world, next(port))
    zero_k1_counts()
    t0 = time.perf_counter()
    recs = calc_metrics.main(["--network", paths["flagship"], "--data", paths["metric_img"],
                              "--metrics", "fid", "--detector", "pixel", "--num-items",
                              str(PAR_METRIC_ITEMS), "--batch", str(PAR_METRIC_BATCH),
                              "--mesh-devices", str(world), "--device", "cuda",
                              "--cache-dir", os.path.join(root, "metric_cache")])
    res["metrics"] = {"launches": k1_counts(), "s": time.perf_counter() - t0,
                      "fid": recs[0]["results"]["fid"] if recs else None}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(k, None)
    with open(os.path.join(root, f"rank{index}.json"), "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Collectives the port runs, tried on CUDA tensors over gloo before the
# world-2 checks on one card.
def _probe_gloo(group) -> dict:
    """{collective: the first line of its error} for each one gloo refuses."""
    import torch.distributed as dist

    t = torch.ones(4, device=group.device)
    probes = {"all_reduce": lambda: dist.all_reduce(t.clone()),
              "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(2)], t),
              "broadcast": lambda: dist.broadcast(t.clone(), src=0)}
    refused = {}
    for name, fn in probes.items():
        try:
            fn()
        except (RuntimeError, ValueError) as e:  # the probe reports it; no check replaces it
            refused[name] = str(e).splitlines()[0][:200]
    torch.cuda.synchronize()
    return refused


def gloo_rank(index: int, init_method: str, root: str, snap: str) -> None:
    """World 2 on cuda:0 over gloo: the probe, then (if nothing was refused)
    the flagship's ray-sharded frame against G.synthesis and a tiny fp32 GAN
    step (R1, PL, ADA 0.3) at global batch 4 against the same step without a
    group, with K1 counted on each rank."""
    import torch.distributed as dist

    from ide3d_tpu_torch.apps import common, gen_images
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.parallel import mesh
    from ide3d_tpu_torch.parallel.render import make_ray_sharded_frame
    from ide3d_tpu_torch.train import gan
    from ide3d_tpu_torch.utils.profiling import check_replica_consistency

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method, rank=index, world_size=2)
    group = mesh.Group(rank=index, size=2, device=torch.device("cuda", 0), backend="gloo")
    res = {"refused": _probe_gloo(group)}
    try:
        if res["refused"]:
            return
        G = common.load_generator(snap, group.device)
        cams = gen_images.yaw_cameras(group.device)
        z = torch.as_tensor(np.stack([np.random.RandomState(s).randn(G.z_dim)
                                      for s in PAR_FRAME_SEEDS]), dtype=torch.float32,
                            device=group.device)
        with torch.inference_mode():
            ws = G.mapping(z, cams)
            ref_img, ref_seg = G.synthesis(ws, cams, return_seg=True)
        zero_k1_counts()
        img, seg = make_ray_sharded_frame(G.synthesis, group)(ws, cams)
        torch.cuda.synchronize()
        u8 = lambda x: torch.round((x + 1) * 127.5).clamp(0, 255).to(torch.int32)
        res["frame"] = {"launches": k1_counts(),
                        "err": max(max_err([img], [ref_img]), max_err([seg], [ref_seg])),
                        "levels": int((u8(img) - u8(ref_img)).abs().max())}
        del G
        torch.cuda.empty_cache()

        def tiny_state(tcfg):
            G = Ide3dGenerator(PRESETS["tiny"]).init(0).to(group.device)
            D = Discriminator(DiscriminatorConfig(img_resolution=32, img_channels=25,
                                                  channel_base=512, channel_max=32,
                                                  dtype="float32")).init(1).to(group.device)
            return gan.init_gan_state(G, D, tcfg)

        tcfg = gan.GanTrainConfig(r1_interval=1, pl_weight=2.0)
        rng = np.random.RandomState(0)
        full = {"img": torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3), np.uint8)).cuda(),
                "seg": torch.from_numpy(rng.randint(0, 19, (4, 32, 32), np.uint8)).cuda(),
                "c": cams[torch.arange(4) % 3].contiguous()}
        dp, one = tiny_state(tcfg), tiny_state(tcfg)
        zero_k1_counts()
        gan.make_gan_train_step(tcfg, group)(dp, mesh.shard_batch(group, full),
                                             torch.Generator("cuda").manual_seed(1), 0.3)
        torch.cuda.synchronize()
        launches = k1_counts()
        gan.make_gan_train_step(tcfg)(one, full, torch.Generator("cuda").manual_seed(1), 0.3)
        res["step"] = {"launches": launches, "rel_err": step_gap(dp, one),
                       "pl_mean": [float(dp.pl_mean), float(one.pl_mean)],
                       "replicas_equal": check_replica_consistency(group, dp.G, dp.D, dp.G_ema)}
    finally:
        with open(os.path.join(root, f"gloo{index}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def parallel_launches(dp: dict, i: int) -> dict:
    """Phase 16's counts of K1's forward (i=0), backward (1) or double
    backward (2), per rank (a list in rank order) for each path."""
    ranks = dp["ranks"]
    out = {k: [r["frames"][k]["launches"][i] for r in ranks] for k in ranks[0]["frames"]}
    out.update({k: [r[k]["launches"][i] for r in ranks]
                for k in ("video", "train_gan", "encoder", "metrics")})
    out["dp_step"] = [r["step"]["launches"]["dp"][i] for r in ranks]
    out["world"] = dp["world"]
    if dp["gloo"] and "frame" in dp["gloo"][0]:
        out["gloo_world2_on_one_card"] = {"frame_b3": [g["frame"]["launches"][i]
                                                       for g in dp["gloo"]],
                                          "tiny_pl_step": [g["step"]["launches"][i]
                                                           for g in dp["gloo"]]}
    return out


def phase_parallel(smi: str, video_frames: np.ndarray) -> dict:
    """Phase 16 (see the module's docstring)."""
    import tempfile

    import torch.multiprocessing as mp

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    world = torch.cuda.device_count()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        paths = {"flagship": os.path.join(root, "flagship"), "hybrid": os.path.join(root, "hybrid")}
        write_snapshot(paths["flagship"], GeneratorConfig(), seed=0)  # phase 8's video G
        write_snapshot(paths["hybrid"], GeneratorConfig(use_feature_volume=True), seed=0)
        data = os.path.join(root, "sphere")
        subprocess.run([sys.executable, "tools/torch_make_synthetic_dataset.py", "--out", data,
                        "--identities", "4", "--views", "2", "--resolution", "512"],
                       check=True, capture_output=True, text=True, timeout=300)
        paths["img"], paths["seg"] = os.path.join(data, "img"), os.path.join(data, "seg")
        paths["metric_img"], _ = write_dataset(os.path.join(root, "metric"), PAR_METRIC_ITEMS,
                                               512)
        inputs_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        mp.spawn(par_rank, args=(world, _free_port(), root, paths), nprocs=world, join=True)
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(world)]
        par_frames_video = np.load(os.path.join(root, "par_video.npy"))
        fid = ranks[0]["metrics"]["fid"]
        fid_1 = fid  # world 1: the group's run is the 1-rank run
        if world > 1:
            from ide3d_tpu_torch.apps import calc_metrics

            fid_1 = calc_metrics.main([
                "--network", paths["flagship"], "--data", paths["metric_img"], "--metrics", "fid",
                "--detector", "pixel", "--num-items", str(PAR_METRIC_ITEMS), "--batch",
                str(PAR_METRIC_BATCH), "--device", "cuda",
                "--cache-dir", os.path.join(root, "metric_cache_1")])[0]["results"]["fid"]

        gloo = None
        if world == 1:
            t0 = time.perf_counter()
            init = "file://" + os.path.join(root, "gloo_store")
            mp.spawn(gloo_rank, args=(init, root, paths["flagship"]), nprocs=2, join=True)
            gloo = [json.load(open(os.path.join(root, f"gloo{r}.json"))) for r in range(2)]
            gloo_s = time.perf_counter() - t0

    # The checks, rank by rank.
    for r, res in enumerate(ranks):
        for key, rec in res["frames"].items():
            B = int(key[-1])
            if rec["launches"] != [1, 0, 0] or rec["k1_shape"][:2] != [B, 4096 // world]:
                raise RuntimeError(f"parallel rank {r} {key}: K1 {rec['launches']} on "
                                   f"{rec['k1_shape']}")
            if rec["k1_err"] > 1e-3 or rec["levels"] > 1:
                raise RuntimeError(f"parallel rank {r} {key}: K1 vs plain {rec['k1_err']}, "
                                   f"{rec['levels']} uint8 levels from G.synthesis")
        if res["video"]["launches"] != [VIDEO_FRAMES // VIDEO_CHUNK, 0, 0]:
            raise RuntimeError(f"parallel rank {r}: gen_videos K1 {res['video']['launches']}")
        want = [4 if r == 0 else 3, 4, 1]  # a PL step, a plain one, rank 0's grid
        if res["train_gan"]["launches"] != want:
            raise RuntimeError(f"parallel rank {r}: train_gan K1 {res['train_gan']['launches']}, "
                               f"want {want}")
        if res["encoder"]["launches"] != [6, 4, 0]:
            raise RuntimeError(f"parallel rank {r}: train_hybrid_encoder K1 "
                               f"{res['encoder']['launches']}, want [6, 4, 0]")
        if res["metrics"]["launches"] != [PAR_METRIC_ITEMS // PAR_METRIC_BATCH, 0, 0]:
            raise RuntimeError(f"parallel rank {r}: calc_metrics K1 {res['metrics']['launches']}")
        if res["step"]["launches"]["dp"] != [1, 1, 0]:
            raise RuntimeError(f"parallel rank {r}: DP step K1 {res['step']['launches']}")
    if world > 1 and not np.isclose(fid, fid_1, rtol=1e-3):
        raise RuntimeError(f"parallel calc_metrics fid {fid} at world {world}, {fid_1} at 1")
    if par_frames_video.shape != video_frames.shape or not np.array_equal(par_frames_video,
                                                                          video_frames):
        diff = (np.abs(par_frames_video.astype(np.int32) - video_frames.astype(np.int32)).max()
                if par_frames_video.shape == video_frames.shape else "shape")
        raise RuntimeError(f"parallel gen_videos: frames differ from phase 8's by {diff}")
    r0 = ranks[0]
    if not np.isfinite(fid):
        raise RuntimeError(f"parallel calc_metrics fid {fid}")
    step = r0["step"]["ms"]
    dp_ms, plain_ms = statistics.median(step["dp"]), statistics.median(step["plain"])
    frames = {k: {kk: v[kk] for kk in ("err", "levels", "k1_err")} for k, v in r0["frames"].items()}
    parts = {"frames": r0["frames_s"], **{k: r0[k]["s"] for k in ("video", "train_gan", "step",
                                                                   "encoder", "metrics")}}
    print(f"parallel: world {world} over NCCL ({smi}); inputs {inputs_s:.1f} s, ranks "
          f"{ranks_s:.1f} s (start, imports and every path; rank 0's paths "
          f"{ {k: round(v, 1) for k, v in parts.items()} } s); ray-sharded frame vs G.synthesis "
          f"per rank {frames}; B=3 frame {r0['frames']['flagship_b3']['ms']:.3f} ms vs "
          f"G.synthesis {r0['frames']['flagship_b3']['synthesis_ms']:.3f} ms (hybrid "
          f"{r0['frames']['hybrid_b3']['ms']:.3f} vs {r0['frames']['hybrid_b3']['synthesis_ms']:.3f}); "
          f"K1 per rank: frame (1, 0, 0) on (B, {4096 // world}, 96, 52), video "
          f"{r0['video']['launches']} (every uint8 frame equal to phase 8's), train_gan "
          f"--pl-weight 2 2 steps {[res['train_gan']['launches'] for res in ranks]} in "
          f"{r0['train_gan']['s']:.1f} s (replicas checked at the snapshot; --resume restored "
          f"every state dict), train_hybrid_encoder 2 steps {r0['encoder']['launches']} in "
          f"{r0['encoder']['s']:.1f} s, calc_metrics fid {PAR_METRIC_ITEMS} items --mesh-devices "
          f"{world} {r0['metrics']['launches']} in {r0['metrics']['s']:.1f} s: fid {fid:.6g} "
          f"(1-rank {fid_1:.6g}); train step batch 4 in turns: plain {step['plain']} ms "
          f"(median {plain_ms:.3f}), data-parallel {step['dp']} ms (median {dp_ms:.3f}, "
          f"{dp_ms - plain_ms:+.3f} ms)", flush=True)
    out = {"world": world, "ranks": ranks, "dp_ms": dp_ms, "plain_ms": plain_ms,
           "inputs_s": inputs_s, "ranks_s": ranks_s, "gloo": None}
    if gloo is not None:
        refused = gloo[0]["refused"]
        if refused:
            print(f"parallel: world 2 on cuda:0 over gloo: refused {refused}; the cross-rank "
                  f"checks are left to the CPU tests (tests/test_torch_parallel.py)", flush=True)
        else:
            for r, g in enumerate(gloo):
                if g["frame"]["launches"] != [1, 0, 0] or g["frame"]["levels"] > 1:
                    raise RuntimeError(f"gloo rank {r}: frame {g['frame']}")
                if g["step"]["launches"] != [2, 3, 1]:  # a PL step
                    raise RuntimeError(f"gloo rank {r}: step K1 {g['step']['launches']}, "
                                       f"want [2, 3, 1]")
                gap = g["step"]["rel_err"]
                if not g["step"]["replicas_equal"] or not gap["moments"] <= GLOO_MOMENT_TOL \
                        or not gap["params"] <= 1e-5:
                    raise RuntimeError(f"gloo rank {r}: step {g['step']}")
            print(f"parallel: world 2 on cuda:0 over gloo in {gloo_s:.1f} s: ray-sharded flagship "
                  f"frame B=3 vs G.synthesis {[g['frame'] for g in gloo]}; tiny fp32 GAN step "
                  f"(R1, PL, ADA 0.3) at global batch 4 vs one process, relative to each "
                  f"tensor's max (params: less Adam's update gap) {gloo[0]['step']['rel_err']}, "
                  f"pl_mean {gloo[0]['step']['pl_mean']}, K1 per rank "
                  f"{[g['step']['launches'] for g in gloo]}, replicas equal", flush=True)
        out["gloo"] = gloo
    wall = time.perf_counter() - t_phase
    print(f"parallel: phase 16 in {wall:.1f} s", flush=True)
    out["wall_s"] = wall
    return out


def phase16_alone() -> dict:
    """Phase 16 on its own (device, build, phase 8's flagship video as its
    reference): `python3 -c "import chip_smoke as cs; cs.phase16_alone()"`."""
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        write_snapshot(snap, GeneratorConfig(), seed=0)
        video = offline_video(snap, "image_seg", os.path.join(root, "f.mp4"), smi,
                              "flagship snapshot")
    return phase_parallel(smi.splitlines()[0], video.pop("frames"))


SERVE_BATCH = 3  # the exported frame's batch: phase 5's three yaws
SERVE_TURNS = ("exported", "eager", "eager", "exported") * 3  # 12 frames of each, in turns
OP_TURNS = ("op", "direct", "direct", "op") * 3  # K1's dispatch: the operator, the direct launch
LOADER_BATCH, LOADER_THREADS, LOADER_BATCHES = 4, 4, 24  # PrefetchLoader's rate, per route
LOADER_EQUAL_BATCHES = 5  # num_threads=1 batches compared between the routes, then prefetched


def _event_ms(fn) -> float:
    """CUDA-event ms of one call, the card idle before it."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def serving_export(root: str) -> dict:
    """The flagship through apps/export_model.main --platforms cuda at batch 3,
    loaded back; the exported frame against G.synthesis and timed beside it."""
    from ide3d_tpu_torch.apps import export_model, gen_images
    from ide3d_tpu_torch.io.export import load_artifact
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator

    out = os.path.join(root, "artifact")
    t0 = time.perf_counter()
    rc = export_model.main(["--network", "random:0", "--outdir", out, "--batch", str(SERVE_BATCH),
                            "--num-steps", "96", "--platforms", "cuda", "--device", "cuda"])
    export_s = time.perf_counter() - t0
    files = sorted(os.listdir(out))
    if rc != 0 or files != ["frame.cuda.pt2", "mapping.cuda.pt2", "meta.json"]:
        raise RuntimeError(f"export_model: rc {rc}, wrote {files}")
    mb = {f: os.path.getsize(os.path.join(out, f)) / 1e6 for f in files if f.endswith(".pt2")}
    t0 = time.perf_counter()
    art = load_artifact(out, device="cuda")
    load_s = time.perf_counter() - t0

    cfg = GeneratorConfig()
    G = Ide3dGenerator(cfg).init(seed=0).to("cuda").eval()  # the weights of random:0
    rp = dataclasses.replace(cfg.render, num_steps=96)
    z = torch.randn(SERVE_BATCH, cfg.z_dim, generator=torch.Generator().manual_seed(0)).cuda()
    cams = gen_images.yaw_cameras("cuda")
    ws = art.map_z(z, cams)
    with torch.inference_mode():
        ws_ref = G.mapping(z, cams)
    art.render(ws, cams)  # warm-up
    torch.cuda.synchronize()
    zero_k1_counts()
    img, seg = art.render(ws, cams)
    torch.cuda.synchronize()
    launches = k1_counts()
    with torch.inference_mode():
        ref_img, ref_seg = G.synthesis(ws, cams, render_params=rp, return_seg=True)
    R = cfg.img_resolution
    for name, t, shape in (("img", img, (SERVE_BATCH, R, R, 3)), ("seg", seg, (SERVE_BATCH, R, R, 19))):
        if tuple(t.shape) != shape:
            raise RuntimeError(f"exported frame: {name} {tuple(t.shape)}, want {shape}")
    _check_finite("exported frame", (ws, img, seg))
    if launches != (1, 0, 0):
        raise RuntimeError(f"exported frame: K1 (forward, backward, double backward) {launches}, "
                           f"want (1, 0, 0)")
    err = {"ws": float((ws - ws_ref).abs().max()), "img": float((img - ref_img).abs().max()),
           "seg": float((seg - ref_seg).abs().max()),
           "img_uint8_levels": int(np.abs(_u8(img) - _u8(ref_img)).max()),
           "seg_argmax_agree": float((seg.argmax(-1) == ref_seg.argmax(-1)).float().mean())}
    if err["ws"] > 1e-5 or err["img_uint8_levels"] > 1:
        raise RuntimeError(f"exported frame vs G.mapping / G.synthesis: {err}")

    def eager():
        with torch.inference_mode():
            G.synthesis(ws, cams, render_params=rp, return_seg=True)

    ms = {"exported": [], "eager": []}
    for kind in SERVE_TURNS:
        ms[kind].append(_event_ms(lambda: art.render(ws, cams) if kind == "exported" else eager()))
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"serving: apps.export_model --network random:0 --batch {SERVE_BATCH} --num-steps 96 "
          f"--platforms cuda in {export_s:.1f} s ({', '.join(f'{k} {v:.2f} MB' for k, v in mb.items())}); "
          f"load_artifact(device='cuda') {load_s:.1f} s; the exported frame at the three yaws: "
          f"K1 {launches}, vs G.mapping / G.synthesis {err}; CUDA-event ms in turns, medians of "
          f"{len(ms['exported'])}: exported {med['exported']:.3f}, eager {med['eager']:.3f} "
          f"(exported {[round(t, 3) for t in ms['exported']]}, eager "
          f"{[round(t, 3) for t in ms['eager']]})", flush=True)
    return {"export_s": export_s, "load_s": load_s, "mb": mb, "launches": launches[0],
            "err": err, "exported_ms": med["exported"], "eager_ms": med["eager"], "G": G}


def op_dispatch(G) -> dict:
    """The eager card path through K1's operator against its direct launch
    (the port's), in turns: K1's eager host and event ms at B=1, a B=1
    frame's event ms, and the wall ms of a Painter cached view through
    PainterWebApp.handle."""
    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.apps.web_ui import PainterWebApp
    from ide3d_tpu_torch.models.encoder import HybridEncoder
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    R, n_geo = G.cfg.img_resolution, G.synthesis.num_ws_geo
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      dtype=G.cfg.dtype).init(seed=1)
    app = PainterWebApp(PainterSession(G=G, E=E.to("cuda").eval(), device="cuda"))
    status, _, _ = app.handle("POST", "/api/seed", {}, json.dumps({"seed": 3, "trunc": 0.7}).encode())
    if status != 200:
        raise RuntimeError(f"op dispatch: seed request status {status}")
    rp = dataclasses.replace(G.cfg.render, num_steps=96)
    cs = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.inference_mode():
        ws = G.mapping(torch.randn(1, G.z_dim, generator=torch.Generator().manual_seed(1)).cuda(), cs)
    args = k1_inputs(torch.Generator().manual_seed(0), torch.bfloat16, B=1, sorted_halves=True)

    def view():
        t0 = time.perf_counter()
        status, _, _ = app.handle("GET", "/api/view", {"yaw": "0.3"}, b"")
        if status != 200:
            raise RuntimeError(f"op dispatch: view request status {status}")
        return (time.perf_counter() - t0) * 1e3

    def frame():
        with torch.inference_mode():
            G.synthesis(ws, cs, render_params=rp)

    def k1():
        with torch.inference_mode():
            ray_march.sort_integrate(*args)

    routes = {"op": ray_march.OP, "direct": ray_march._launch_forward}  # OP's kernel: the latter
    rows = {k: {"k1_event_ms": [], "k1_host_ms": [], "frame_b1_ms": [], "view_wall_ms": []}
            for k in routes}
    try:
        for kind in ("op", "direct"):  # warm-up of each route
            ray_march._launch_forward = routes[kind]
            view(), frame(), k1()
        for kind in OP_TURNS:
            ray_march._launch_forward = routes[kind]
            ev, host = eager_ms(k1)
            rows[kind]["k1_event_ms"].append(ev)
            rows[kind]["k1_host_ms"].append(host)
            rows[kind]["frame_b1_ms"].append(statistics.median(_event_ms(frame) for _ in range(5)))
            zero_k1_counts()
            rows[kind]["view_wall_ms"].append(statistics.median(view() for _ in range(3)))
            if k1_counts() != (3, 0, 0):
                raise RuntimeError(f"op dispatch ({kind}): K1 {k1_counts()} over 3 cached views")
    finally:
        ray_march._launch_forward = routes["direct"]
    med = {k: {m: statistics.median(v) for m, v in r.items()} for k, r in rows.items()}
    print(f"serving: K1's operator against the direct launch on the eager path, "
          f"{len(OP_TURNS) // 2} turns each, medians {json.dumps(med)} (every turn "
          f"{json.dumps({k: {m: [round(x, 4) for x in v] for m, v in r.items()} for k, r in rows.items()})})",
          flush=True)
    return med


def host_loader(root: str) -> dict:
    """PrefetchLoader on 512² views on the native and the numpy route, and
    prefetch_to_device over a finite run of its batches."""
    import threading

    from ide3d_tpu_torch.data import CameraLabeledDataset, PrefetchLoader, _native
    from ide3d_tpu_torch.parallel.mesh import prefetch_to_device

    if _native.route() != "native":
        raise RuntimeError(f"host ops: the numpy route runs: {_native.build_error()}")
    data = os.path.join(root, "sphere")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "tools/torch_make_synthetic_dataset.py", "--out", data,
                    "--identities", "4", "--views", "2", "--resolution", "512"],
                   check=True, capture_output=True, text=True, timeout=300)
    data_s = time.perf_counter() - t0
    ds = CameraLabeledDataset(os.path.join(data, "img"), os.path.join(data, "seg"), xflip=True)
    native_lib = _native._lib

    def numpy_route(on: bool):
        _native._lib = (lambda: None) if on else native_lib

    rate, equal = {}, {}
    try:
        for route in ("native", "numpy"):
            numpy_route(route == "numpy")
            loader = PrefetchLoader(ds, LOADER_BATCH, seed=0, num_threads=LOADER_THREADS)
            try:
                next(loader)  # the threads started
                t0 = time.perf_counter()
                for _ in range(LOADER_BATCHES):
                    next(loader)
                rate[route] = LOADER_BATCHES / (time.perf_counter() - t0)
            finally:
                loader.close()
            loader = PrefetchLoader(ds, LOADER_BATCH, seed=1, num_threads=1)
            try:
                equal[route] = [next(loader) for _ in range(LOADER_EQUAL_BATCHES)]
            finally:
                loader.close()
    finally:
        numpy_route(False)
    host = equal["native"]
    for a, b in zip(host, equal["numpy"]):
        if sorted(a) != ["c", "img", "seg"] or any(not np.array_equal(a[k], b[k]) for k in a):
            raise RuntimeError("host ops: the native and numpy routes' batches differ")
    b0 = host[0]
    if b0["img"].shape != (LOADER_BATCH, 512, 512, 3) or b0["seg"].shape != (LOADER_BATCH, 512, 512, 19) \
            or not np.isfinite(b0["img"]).all() or set(np.unique(b0["seg"])) != {-1.0, 1.0}:
        raise RuntimeError(f"host loader: batch img {b0['img'].shape} seg {b0['seg'].shape}")

    got = []
    t0 = time.perf_counter()
    worker = threading.Thread(target=lambda: got.extend(prefetch_to_device(iter(host), "cuda")),
                              daemon=True)
    worker.start()
    worker.join(timeout=120)
    prefetch_s = time.perf_counter() - t0
    if worker.is_alive():
        raise RuntimeError("prefetch_to_device did not end on a finite loader")
    torch.cuda.synchronize()
    if len(got) != len(host):
        raise RuntimeError(f"prefetch_to_device yielded {len(got)} of {len(host)} batches")
    for dev, h in zip(got, host):
        for k, v in h.items():
            if dev[k].device != torch.device("cuda", 0) or not torch.equal(dev[k].cpu(),
                                                                           torch.from_numpy(v)):
                raise RuntimeError(f"prefetch_to_device: {k} on {dev[k].device}, or not the host batch")
    print(f"serving: host ops route {_native.route()}; tools/torch_make_synthetic_dataset.py 8 "
          f"views at 512² in {data_s:.1f} s; PrefetchLoader batch {LOADER_BATCH}, "
          f"{LOADER_THREADS} threads, xflip: {rate['native']:.2f} batches/s native, "
          f"{rate['numpy']:.2f} numpy ({LOADER_BATCHES} batches each); {LOADER_EQUAL_BATCHES} "
          f"one-thread batches equal between the routes; prefetch_to_device over them ended in "
          f"{prefetch_s:.2f} s, every tensor on cuda:0 and equal to its host batch", flush=True)
    return {"batches_per_s": rate, "prefetch_s": prefetch_s}


def phase_serving(smi: str) -> dict:
    """Phase 17 (see the module's docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = serving_export(root)
        out["op"] = op_dispatch(out.pop("G"))
        out["loader"] = host_loader(root)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"serving: phase 17 in {out['wall_s']:.1f} s ({smi})", flush=True)
    return out


def phase17_alone() -> dict:
    """Phase 17 on its own (device, build):
    `python3 -c "import chip_smoke as cs; cs.phase17_alone()"`."""
    smi = phase_device()
    phase_build()
    return phase_serving(smi.splitlines()[0])


# Phase 18: the flagship run B mode of tools/torch_trained_workflow.py at cut
# counts, run as a user runs it; the workflow prints its stages' JSON lines
# to <out>/workflow.jsonl, which the phase reads.
FLAGSHIP_CUT = ("--identities", "2", "--kimg", "0.05", "--kimg2", "0.1", "--metric-items", "32")
FLAGSHIP_K1_SHAPE = [4, 4096, 96, 52]  # batch 4, the 64² render's rays, 96 + 96, C + 1


def phase_flagship(smi: str) -> dict:
    """Phase 18 (see the module's docstring)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "out")
        p = subprocess.run([sys.executable, "tools/torch_trained_workflow.py", "--run", "flagship",
                            "--out", out, "--root", os.path.join(root, "work"), "--stages",
                            "dataset,k1,gan,resume", *FLAGSHIP_CUT],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=900)
        if p.returncode:
            sys.stderr.write(p.stdout[-3000:] + p.stderr[-6000:])
            raise RuntimeError(f"flagship run: the workflow failed (rc {p.returncode})")
        recs = {}
        with open(os.path.join(out, "workflow.jsonl")) as f:
            for ln in f:
                rec = json.loads(ln)
                recs.setdefault(rec["stage"], []).append(rec)
        stats, fids = ([json.loads(ln) for ln in open(os.path.join(out, name)) if ln.strip()]
                       for name in ("torch_flagship_runB_stats.jsonl",
                                    "torch_flagship_runB_metric_fid.jsonl"))
        grids = sorted(os.listdir(os.path.join(out, "img")))
    k1, res = recs["k1"][0], recs["resume_check"][0]
    if (k1["dtype"] != "torch.bfloat16" or k1["vals"] != [FLAGSHIP_K1_SHAPE] * 2
            or k1["step_launches"] != [1, 1, 0] or not k1["finite"]
            or k1["fwd_max_abs_err"] > 1e-3 or k1["bwd_err_of_max_grad"] > 1e-2):
        raise RuntimeError(f"flagship run: the k1 stage {k1}")
    values = [v for r in stats for v in r.values()] + [r["results"]["fid"] for r in fids]
    if not all(np.isfinite(values)) or min(res["rows"]) < 1 or len(fids) != 2 or not grids:
        raise RuntimeError(f"flagship run: stats {stats}, fid {fids}, grids {grids}")
    if (len(stats) != sum(res["rows"]) or res["fid_kimg"] != [r["kimg"] for r in fids]
            or abs(res["resumed_ada_p"] - res["leg1_last"]["ada_p"]) > res["one_update"]):
        raise RuntimeError(f"flagship run: the resume {res}")
    stage_s = {r["stage"]: r["wall_s"] for r in recs.get("dataset", []) + recs["gan"]
               + recs["resume"]}
    wall = time.perf_counter() - t0
    print(f"flagship run: k1 stage bf16 {k1['vals'][0]} x 2, K1 {k1['step_launches']} in its "
          f"step, forward err {k1['fwd_max_abs_err']:.3g} (<= 1e-3), backward "
          f"{k1['bwd_err_of_max_grad']:.3g} x max|grad| (<= 1e-2), unsorted rays coarse / fine "
          f"{k1['rays_unsorted_coarse_fine']} of {4 * 4096}; {len(stats)} stats rows "
          f"({res['rows'][0]} + {res['rows'][1]}), FID {[round(r['results']['fid'], 1) for r in fids]} "
          f"at kimg {res['fid_kimg']}, resumed at step {res['resumed_step']} ada_p "
          f"{res['resumed_ada_p']:.6g} (leg 1's last {res['leg1_last']['ada_p']:.6g}); "
          f"grids {grids}; stages {', '.join(f'{k} {v:.1f} s' for k, v in stage_s.items())}; "
          f"phase 18 in {wall:.1f} s ({smi})", flush=True)
    return {"k1": k1, "resume": res, "stage_s": stage_s, "wall_s": wall}


def phase18_alone() -> dict:
    """Phase 18 on its own (device, build):
    `python3 -c "import chip_smoke as cs; cs.phase18_alone()"`."""
    smi = phase_device()
    phase_build()
    return phase_flagship(smi.splitlines()[0])


def main() -> None:
    smi = phase_device()
    phase_build()
    k = phase_kernel(smi.splitlines()[0])
    phase_fp32()
    f, G = phase_frame()
    p = phase_painter(G, smi.splitlines()[0])
    del G
    tr = phase_train(smi.splitlines()[0])
    off = phase_offline(smi.splitlines()[0])
    met = phase_metrics(smi.splitlines()[0])
    inv = phase_inversion(smi.splitlines()[0])
    ed = phase_editing(smi.splitlines()[0])
    pre = phase_preprocess(smi.splitlines()[0])
    arch = phase_arch(smi.splitlines()[0])
    par = phase_parity(smi.splitlines()[0])
    tools = phase_tools(smi.splitlines()[0])
    dp = phase_parallel(smi.splitlines()[0], off["video"]["flagship"].pop("frames"))
    serve = phase_serving(smi.splitlines()[0])
    fl = phase_flagship(smi.splitlines()[0])
    off["video"]["ref_compat"].pop("frames")
    main_path, b1 = k["timing"][3], k["timing"][1]  # the frame runs K1 at B=3
    kb = tr["k1_backward"]
    kd = par["k1_double_backward"]
    print(json.dumps({"kernels": [{
        "name": "sort_integrate",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "launches": f["launches"],
        "max_abs_err": max(k["max_abs_err"], f["frame_err"], off["mesh"]["k1_err"],
                           *(v["k1_err"] for v in off["video"].values()),
                           *met["counted"]["k1_err"].values(), inv["k1"]["fwd_err"],
                           ed["k1"]["fwd_err"], ed["viz"]["k1"]["fwd_err"], arch["k1_err"],
                           tools["eval"]["k1_err"], fl["k1"]["fwd_max_abs_err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "eager_ms": main_path["eager_ms"],
        "host_ms": main_path["host_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bytes": main_path["bytes"],
        "bound_share": main_path["bound_share"],
        "b1": b1,
        "ms_on_frame_inputs": f["k1_frame_ms"],
        "painter_launches": {"per_request": p["launches"], "per_round": p["per_round"]},
        "train_launches": sum(n[0] for n in tr["full"]["launches"]),
        "train_b4": {"ms": kb["fwd_ms_b4"], "bound_ms": kb["fwd_bound_ms_b4"]},
        "video_launches": {k: v["launches"] for k, v in off["video"].items()},
        "video_max_abs_err": {k: v["k1_err"] for k, v in off["video"].items()},
        "mesh_launches": off["mesh"]["launches"],
        "mesh_max_abs_err": off["mesh"]["k1_err"],
        "metrics_launches": {k: v["launches"] for k, v in met["counted"]["per"].items()},
        "metrics_max_abs_err": met["counted"]["k1_err"],
        "inversion_launches": inversion_launches(inv, 0),
        "inversion_max_abs_err": inv["k1"]["fwd_err"],
        "editing_launches": {**{f"{k}_step": v[0] for k, v in ed["launches"].items()},
                             "styleclip_edit_per_yaw": ed["edit_launches"] // 3,
                             "face_animation_per_frame": ed["viz"]["anim_launches"],
                             "log_replay_per_entry": ed["viz"]["replay_launches"],
                             "edit_comparison_total": ed["cmp"]["launches"]},
        "viz_launches": {"render": 1, "capture_layers": ed["viz"]["capture_launches"],
                         "generate_planes_for_4_identities": ed["viz"]["planes"]},
        "editing_max_abs_err": {"mapper_step": ed["k1"]["fwd_err"],
                                "viz_48_48": ed["viz"]["k1"]["fwd_err"]},
        "preprocess_launches": preprocess_launches(pre, 0),
        "arch_launches": arch_launches(arch, 0),
        "arch_max_abs_err": {"hybrid_b3": arch["hybrid"]["k1_err"],
                             "hybrid_b3_density_moved": arch["hybrid"]["k1_err_moved"],
                             "sg3_b3": arch["sg3"]["k1_err"],
                             "fine_64_128": arch["fine"]["k1_err"]},
        "tools_launches": {k: tools[v]["launches"][0] for k, v in (
            ("eval_trained_encoder", "eval"), ("painter_trained_demo", "demo"),
            ("import_and_verify", "import"))},
        "tools_max_abs_err": {"eval_trained_encoder_b8": tools["eval"]["k1_err"]},
        "parallel_launches": parallel_launches(dp, 0),
        "parallel_max_abs_err": {k: v["k1_err"] for k, v in dp["ranks"][0]["frames"].items()},
        "export_launches": serve["launches"],
        "exported_frame_ms": serve["exported_ms"],
        "eager_frame_ms": serve["eager_ms"],
        "op_dispatch": serve["op"],
        "flagship_run_launches": fl["k1"]["step_launches"][0],
    }, {
        "name": "sort_integrate_backward",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "autodiff_of": "ide3d_tpu/render/integration.py:85",
        "launches": sum(n[1] for n in tr["full"]["launches"]),
        "max_abs_err": max(kb["max_abs_err"], inv["k1"]["bwd_err"], ed["k1"]["bwd_err"],
                           fl["k1"]["bwd_err_of_max_grad"]),
        "max_abs_err_is": "relative to max|grad|",
        "ms": kb["ms"],
        "plain_ms": kb["plain_ms"],
        "bound_ms": kb["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bytes": kb["bytes"],
        "bound_share": kb["bound_share"],
        "fwd_bwd_ms": kb["fwd_bwd_ms"],
        "fwd_bwd_bound_ms": kb["fwd_bwd_bound_ms"],
        "train_step": {k: tr["full"][k] for k in ("median_ms", "r1_step_ms", "warm_r1_step_ms",
                                                  "peak_gib", "imgs_per_s")},
        "inversion_launches": inversion_launches(inv, 1),
        "inversion_max_abs_err": inv["k1"]["bwd_err"],
        "inversion_step_ms": {**inv["median_ms"], "encoder": inv["encoder"]["median_ms"]},
        "editing_launches": {f"{k}_step": v[1] for k, v in ed["launches"].items()},
        "editing_max_abs_err": ed["k1"]["bwd_err"],
        "editing_step_ms": ed["median_ms"],
        "preprocess_launches": preprocess_launches(pre, 1),
        "preprocess_step_ms": pre["step_median_ms"],
        "arch_launches": arch_launches(arch, 1),
        "parity_launches": {"pl_step": par["full"]["pl_step_launches"][1],
                            "plain_step": par["full"]["plain_step_launches"][1]},
        "parallel_launches": parallel_launches(dp, 1),
        "parallel_step_ms": {"data_parallel": dp["dp_ms"], "plain": dp["plain_ms"]},
        "flagship_run_launches": fl["k1"]["step_launches"][1],
    }, {
        "name": "sort_integrate_double_backward",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "autodiff_of": "ide3d_tpu/render/integration.py:85",
        "launches": sum(n[2] for n in par["full"]["launches"]),
        "max_abs_err": kd["max_abs_err"],
        "max_abs_err_is": "relative to max|grad|",
        "ms": kd["ms"],
        "plain_ms": kd["plain_ms"],
        "bound_ms": kd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bytes": kd["bytes"],
        "bound_share": kd["bound_share"],
        "design": "PR 13",
        "plan": kd["plan"],
        "streamed_ms": kd["streamed_ms"],
        "parity_launches": {"pl_step": par["full"]["pl_step_launches"][2],
                            "plain_step": par["full"]["plain_step_launches"][2],
                            "train_gan_2_steps": par["app"]["launches"][2]},
        "train_step": {"pl_ms": par["full"]["pl_ms"], "plain_ms": par["full"]["plain_ms"],
                       "pl_peak_gib": par["full"]["pl_peak_gib"],
                       "plain_peak_gib": par["full"]["plain_peak_gib"],
                       "wavelet_ms": par["full"]["warp"],
                       "wavelet_peak_gib": par["full"]["warp_peak_gib"]},
        "parallel_launches": parallel_launches(dp, 2),
    }, flrelu_entry(arch["sg3"])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
