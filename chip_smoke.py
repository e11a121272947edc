"""Drive the PyTorch port (``odin_tpu_torch``) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

It builds the CUDA kernels from ``odin_tpu_torch/csrc`` with plain nvcc
(at first use, into ``build/``), holds each kernel against its plain
PyTorch version on the card, drives the port's main paths through the entry
points a user calls, and checks their outputs against the same calls on the
CPU:

  1. device and build: the card's name and power limit, the nvcc build;
  2. K1 (``ops/logmel.py``), its three kernels against
     ``logmel_reference``: the FFT kernel at the speech path's shape (64 x
     4 s = 25,472 frames of 400 samples, n_fft 512), at a ragged 1,000
     frames, at n_fft 1024 with 1024-sample frames, with 1024-sample frames
     folded into n_fft 512 and at n_fft 8192; the mixed-radix FFT kernel at
     Whisper's framing (n_fft 400, 80 mels from 0 Hz: 25,472 frames and a
     ragged 1,000), at n_fft 480 (30 ms at 16 kHz), 1200 (25 ms at 48
     kHz) and 882 (20 ms at 44.1 kHz: odd n_fft/2), with 1000-sample frames
     folded into n_fft 400 and 300-sample frames padded to it; the
     dense-DFT kernel at n_fft 551 (25 ms at 22,050 Hz, 80 mels: 551 is
     odd); each on white noise and on ``harmonic_frames`` (about 80 dB
     across the mel bands), within 0.01 dB, with CUDA-event timings of each
     kernel, the plain version and ``torch.fft.rfft`` + mel (a yardstick
     the port never calls), and of the dense kernel at the FFT kernels'
     shapes beside them (each timing: CUDA events around bursts of 10
     back-to-back calls, median of 10 bursts);
  3. the speech path: ``batch_speech_features`` on 64 int16 utterances of
     2-4 s, against the same call on the CPU, and its rate in valid
     (unpadded) frames/s with the host-to-device copy, which launches the
     FFT kernel once for the batch; then the same utterances at Whisper's
     framing, which launches the mixed-radix kernel once, and at 25 ms
     frames at 22,050 Hz (n_fft 551), which launches the dense kernel
     once;
  4. the serving path: the full-width dSprites beta-VAE answering
     ``encode_mean``, ``decode_mean`` and ``reconstruct`` at batch 1 and
     256, against the same model on the CPU, with batch-1 latency and
     batch-256 images/s;
  5. K2 (``ops/flash_attention.py``) against ``flash_attention_reference``
     at the benchmark width (B 4, H 8, T 4096, D 64) in fp32, bf16 and fp16
     (the fp32 FMA kernel and the 16-bit tensor-core kernel), non-causal and
     causal, at ragged and small shapes, and at D 256 in each dtype (two
     launches in fp32), within 2e-5 (fp32), 1e-5 + 2^-6·|plain| (bf16) and
     1e-5 + 2^-9·|plain| (fp16), with CUDA-event timings of the kernel, the
     plain version and ``scaled_dot_product_attention`` (a yardstick the
     port never calls) in each dtype;
  6. the attention path: ``MultiHeadAttention(num_heads=8,
     qkv_features=512, flash=True)`` on (4, 4096, 512), forward and
     gradient, against the same module with ``flash=False`` on the card and
     against the CPU at T 1024, with host-timed forward and forward+backward
     steps; then the same layer cast to bf16 and to fp16 (the 16-bit kernel),
     forward, against the fp32 layer beside ``flash=False`` in that dtype;
  7. the training path: the full-width dSprites ``BetaVAE(beta=1)`` at batch
     64, Adam at 1e-3 with NaN-skip: 3 steps on the card against the CPU
     (gradients, losses, params) on the same batches and noise; 20 steps
     through ``scan_steps`` (a CUDA graph) against 20 eager steps, in fp32
     and in bf16 compute, with cuDNN's default algorithms; a batch
     holding a NaN, eager and graphed, leaving params and moments bitwise
     unchanged; 500 ``device_dataset_steps`` on 16,384 procedural dSprites
     images resident on the card as uint8, the held-out loss falling below
     half its start; then steps/s eager, graphed (500 steps a call, fp32 and
     bf16 compute) and drawing batches on the card, with the capture times,
     the
     model FLOPs a step and their share of the card's peak, and a profile
     of 20 graphed steps by kernel.  The path launches no kernel of this
     port (cuDNN and cuBLAS run its convolutions and products);
  8. the fit path, the README's training quickstart: ``get_dataset
     ('dsprites')`` (16,384 procedural images), ``BetaVAE(beta=4.0,
     **get_networks('dsprites', zdim=10)).build()`` on the card and
     ``vae.fit(ds.create_dataset('train', batch_size=64, epochs=-1,
     prefetch=2, to_device=cuda), ...)`` with a validation set every 100 or
     500 steps, ``log.jsonl`` in a directory under ``build/`` and
     non-blocking checkpoints: 300 steps at ``steps_per_call=1`` (a graph
     of one step a call) and 1000 at ``steps_per_call=100`` (the held-out
     loss below half its start), each log's records at the steps expected
     and its last checkpoint restored bitwise equal to the state; then
     ``fit_device_dataset`` 500 + 500 steps split by a checkpoint and
     ``load_weights``, bitwise equal to 1000 unbroken steps (cuDNN's
     deterministic algorithms); steps/s of each mode beside phase 7's
     graphed step, and a host-fed step split into the pipeline's host
     work, the pinned copy and the step.  ``max_iter`` is cut from the
     quickstart's 10,000 so that the script stays inside its time limit;
  9. the corpus path: the port's synthetic speaker corpus (64 speakers x 32
     utterances of 8 s at 16 kHz, each cut to 4-8 s: 2048 int16 wav files,
     written under ``build/`` by a child process while phases 2-8 run)
     through ``DeviceCorpusProcessor`` at batch 64, one K1 launch a batch,
     its store against ``batch_speech_features`` on the card for every
     utterance and against the CPU for the first 128 files, its indices
     and sums, the float16 transfer on 512 files, files/s, frames/s and the
     phase split; ``validate_features``; ``calculate_pca`` on the card
     against the CPU; ``AudioFeatureLoader`` on 256 files in both compats
     against the CPU; 64 streams of 8 s through ``streaming_step`` in
     chunks of 0.1 s against offline ``speech_features``, with the chunk
     latency; Griffin-Lim (32 iterations) on 64 utterances of 2 s against
     the CPU from a shared initial phase;
 10. the gym path, the README quickstart's evaluation, on phase 8's model
     (``fit`` at ``steps_per_call=100``, 1000 steps):
     ``DisentanglementGym(dataset=get_dataset('dsprites'), model=vae)
     .run_model(n_samples=10000, partition='test')`` and ``write_report``
     with the default scores and FID, no ``_error`` key; ``z_mean`` of the
     first 2,000 images against the same model on the CPU within 1e-4,
     the per-sample ELBO terms on the card's noise within rtol 1e-4;
     every estimator on the card against the port's CPU path fed the
     card's own latents (MIG to 1e-10, the FactorVAE votes exactly, the
     beta-VAE score and accuracy probe to one prediction, SAP to two of
     the test split, DCI to 1e-6 and one prediction, TC and FID to rtol
     1e-4 on the first 2,000 rows, the unweighted KL to rtol 1e-4), with
     the time of
     ``run_model`` and of each score on both.  The Gym launches no kernel
     of this port;
 11. the speaker path, the README's speaker quickstart, on phase 9's 2048
     wav files (64 speakers; utterances 0-19 train, 20-31 test):
     ``batch_speech_features(raw, features=("mfcc_cmvn",))`` (one K1 launch
     a batch of 64: 32), ``Ivector(nmix=512, tv_dim=100).fit_transform``
     on the train split with its cache, ``transform`` of the test split,
     ``Scorer(method="cosine", wccn=True)`` against the 64 speakers (EER,
     minDCF, accuracy) and ``PLDA(n_phi=16, n_iter=8)``'s test x test
     ``score_matrix`` (EER) and ``predict``; the UBM's llk rising over
     the mixup levels, the cosine EER and PLDA accuracy within limits set
     from the CPU at nmix 64; the card against the port's CPU path from
     the same state on the first 128 files (a GMM E-step and
     ``transform_batch`` within 1e-4, a T-matrix E-step and the i-vectors
     within 3e-4, Scorer and PLDA fitted on the CPU from the card's
     i-vectors within 1e-9 and the same EERs); a second ``Ivector`` on the
     cache, bitwise the same i-vectors; each stage's time, and the
     E-step alone at 512 mixtures x 60 dims over 1M frames on the card.
 12. the zoo path, on ``get_dataset('dsprites')`` and the full-width
     ``get_networks('dsprites', zdim=10)`` (``vq_dsprites_networks`` for
     the spatial VQ-VAE with an EMA codebook and restarts): for each of
     Autoencoder, FactorVAE, Factor2VAE, DIPVAE i and ii, InfoVAE, MIVAE,
     irmVAE, irmAE, HypersphericalVAE (vMF), PowersphericalVAE,
     TwoStageVAE, VampriorVAE, VQVAE, StochasticVAE, ImputeVAE and
     DistEncoder (on the factors), with BetaVAE as the yardstick: the ELBO
     terms on the card against the CPU on the same params, batch and noise
     (rtol 1e-4 of each term's largest magnitude), 300 steps of
     ``vae.fit(..., steps_per_call=100)`` at batch 64 (128 for the two
     FactorVAEs, which split it) with no update skipped and the held-out
     loss below its start, steps/s (after a discarded warm-up fit), and
     ``run_model`` with MIG on 2,000 test images (not for the VQ-VAE,
     whose latents are a code map); then
     FactorVAE at Kim & Mnih's dSprites setting (tc_coef 35, the 5 x 1000
     discriminator) for 1000 steps, ``DisentanglementGym(dataset=ds,
     model=vae).run_model(n_samples=10000, partition='test')`` and
     ``write_report()`` with no ``_error`` key (MIG, SAP, DCI, beta-VAE
     and FactorVAE scores printed); the vMF sampler's rejected rows (0)
     and acceptance rate.  The path launches no kernel of this port.
     ``python3 chip_smoke.py --zoo-profile [CLASS ...]`` runs only a
     profile of the zoo's graphed steps (``zoo_profile``), the
     semi-supervised classes' too.
 13. the semi path, on (x, y, mask) batches of ``create_dataset("train",
     batch_size=64, label_percent=0.1, oversample_ratio=0.5,
     to_device=cuda)``: for each of MultitaskVAE, SkiptaskVAE,
     MultiheadVAE, M2VAE, ConditionalM2VAE, StructuredSemiVAE,
     reparamsM3VAE, auxiliaryVAE, SemafoVAE, RemafoVAE, semafod, semafoh,
     semafos, semafosm, semafosc, semafop, semafot, SemiFactorVAE and
     SemiFactor2VAE on ``get_networks('dsprites', zdim=10,
     is_semi_supervised=True)`` (``semi_models``: the factors' Gaussian
     head, or a one-hot head over the x position in 4 bins for the classes
     whose objective needs class probabilities): the ELBO terms on the
     card against the CPU (rtol 1e-4 of each term's largest magnitude),
     200 steps of ``fit`` at ``steps_per_call=100`` (JAX's defaults: the
     Semafo family's MI term trains from step 1,000) with no update
     skipped and the held-out loss below its start, the labels head's
     log-likelihood of 256 held-out labelled images above its value
     before training, steps/s, ``run_model`` and MIG on 2,000 test
     images; then M2VAE and ConditionalM2VAE on ``HalfMoons`` with the
     one-hot head for 1000 steps: ``classify`` accuracy on the 320 test
     points of at least 0.95, and ConditionalM2's ``marginal_elbo`` within
     1e-5 of the explicit sum over the two one-hot labels on the card.
     The path launches no kernel of this port.  ``python3 chip_smoke.py
     --semi-rehearsal [...]`` runs the phase on the CPU at a chosen size
     (``semi_rehearsal``);
 14. the hier path, on ``get_dataset('dsprites')`` and the full-width
     ``get_networks('dsprites', zdim=10)`` with JAX's ``hierarchy`` spec
     (one rung on the 16 x 16 states, kernel 8, stride 4): for each of
     HierarchicalVAE (LadderVAE) with a BiConv, a parallel and a BiDense
     rung, UnetVAE, PUnetVAE and VeryDeepVAE on images, and GroupVAE,
     MultiLevelVAE, AdaptiveVAE (group and multilevel) and
     WeaklySupervisedVAE (match, rank, restricted) on pairs rendered by
     ``dSprites.render`` from factor rows (``dsprites_pairs``: k = Rnd of
     the five factors changed, one changed, the x position changed with
     y = which is larger, shape and scale shared and given), BetaVAE the
     yardstick, each at JAX's defaults but PUnetVAE and the BiDense
     ladder trained with ``global_clipnorm=10`` (``hier_models``): the
     ELBO terms (each rung's ``kl_ladder{i}``, ``pair_loss``) on the card
     against the CPU (rtol 1e-4 of each term's largest magnitude), the
     grouped models' mean count of shared dimensions equal (a row that a
     tie decides is reported), the kernels and device time of a graphed
     step beside BetaVAE's, 200 steps of ``fit`` at
     ``steps_per_call=100`` at batch 64 (64 pairs) with no update skipped
     and the held-out loss below its start, steps/s, ``run_model`` and MIG
     on 2,000 test images (unpaired for the grouped family), for the
     hierarchical models the Gym's KL of a batch equal to the sum of the
     model's own KL terms and ``sample_observation`` finite; then
     UnetVAE(skip_sample_dropout=1.0)'s training decode equal to its
     generation decode, bitwise with cuDNN's deterministic algorithms.
     The path launches no kernel of this port.  ``python3 chip_smoke.py
     --hier-rehearsal [...]`` runs the phase on the CPU at a chosen size
     (``hier_rehearsal``);
 15. the clustering path, on phase 10's Gym (10,000 test latents):
     ``write_report`` with the default scores and 'clustering', no
     ``_error`` key; ``clustering_score`` of each of the five factors;
     ``correlation_matrix`` and ``relative_disentanglement_strength`` by
     'lasso' and 'mutualinfo'; ``mutual_info_estimate``; ``discretizing``
     in 10 bins by 'quantile', 'kmeans' and 'gmm'; the data of the ten
     plots and ``plot_latent_stats``, with the t-SNE of all 10,000 latents
     (its KL below, and its trustworthiness at k 5 above, those of its PCA
     start, computed on the card); each held against the port's CPU path
     fed the card's own latents on the first 2,000 rows (ARI, AMI and NMI
     to 1e-12, silhouette and the k-NN mutual information to 1e-6, Lasso
     to 1e-6 of its largest coefficient, the quantile and kmeans bins
     equal and the gmm bins on all but 0.5 %, plot data to 1e-4 and the
     histograms' counts equal, t-SNE's P and one gradient to 1e-6).  Then
     ``KMeansJax(n_clusters=512, n_iter=50)`` on 1M x 60 fp32 frames of a
     seeded 512-component Gaussian mixture drawn on the card (the GMM-UBM
     E-step's shape): the float64 inertia never rising, 65,536 labels the
     float64 argmin of their rows, each centre its members' mean within
     1e-5, the seeding time and the ms a Lloyd iteration; its seeds,
     labels and iterations on the CPU at 65,536 rows and 64 clusters;
     ``fast_kmeans(framework='sklearn', n_clusters=64)`` on the first
     100,000 frames; ``fast_knn(n_neighbors=5)`` from the latents to the
     first factor (8,000 train, 2,000 test rows); ``fast_dbscan`` at the
     median 5-NN distance and ``dbscan_predict`` of the held-out rows; and
     ``fast_naive_bayes`` (categorical, multinomial, bernoulli) on the
     latents in 10 bins; each against the CPU.  The path launches no
     kernel of this port.

Run with no argument, it runs every phase: the whole check.  ``python3
chip_smoke.py --phases 1,14`` runs the phases named, phase 1 (the build)
always, and every phase whose results a named one reads
(``PHASE_NEEDS``: 3 reads 2, 6 reads 5, 8 reads 7, 10 reads 8, 11 reads 2
and 9, 15 reads 10); its ``kernels`` line lists only the kernels those
phases timed.

TF32 is off for matmuls and cuDNN convolutions, so the card computes in
fp32 like the CPU.  Any failure raises and the script exits non-zero; it
also exits non-zero, printing no result, where no CUDA card is visible.
The last line is the JSON object ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` summary.
"""
import atexit
import json
import math
import subprocess
import sys
import time

T_START = time.perf_counter()
SEED = 0
FP32_PEAK_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
TF32_PEAK_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
LOGMEL_TOL_DB = 0.01
SERVING_ATOL = 1e-4
ATTN_ATOL = 2e-5  # fp32 attention outputs (tests/test_flash_attention.py)
# bf16 attention: kernel and plain version both sum in fp32 and round each
# output once to bf16, so they may differ by one rounding of that output;
# the limit is two roundings, 2^-6·|plain|, beside 1e-5 for fp32 sums
ATTN_BF16_RTOL = 2 ** -6
ATTN_BF16_ATOL = 1e-5
# fp16 attention: the same two roundings, of fp16's 11-bit significand
ATTN_FP16_RTOL = 2 ** -9
ATTN_GRAD_ATOL = 1e-4  # attention gradients (tests/test_flash_attention.py)
ATTN_CPU_ATOL = 1e-4  # card against CPU, fp32 sums in another order


def log(msg):
  print(msg, flush=True)


class Phase:
  """Prints one line with the phase's elapsed seconds when it ends."""

  def __init__(self, name):
    self.name = name

  def __enter__(self):
    self.t0 = time.perf_counter()
    log(f"[phase] {self.name} ...")
    return self

  def __exit__(self, *exc):
    status = "FAILED" if exc[0] is not None else "ok"
    log(f"[phase] {self.name}: {status} in "
        f"{time.perf_counter() - self.t0:.2f} s")
    return False


def cuda_ms(torch, fn, reps=10, burst=10, warmup=3):
  """Median device time of one call of `fn` in ms: a pair of CUDA events
  around each burst of `burst` back-to-back calls, so that a call's host
  work overlaps the previous call's kernel, over the count; the median of
  `reps` bursts."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(burst):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / burst)
  times.sort()
  return times[len(times) // 2]


def host_times_s(torch, fn, reps):
  """Sorted host-clock seconds of `reps` calls, each ending synchronised."""
  times = []
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
  return sorted(times)


TRAIN_BATCH = 64  # bench.py's BATCH
TRAIN_LR = 1e-3
TRAIN_STEPS = 500  # bench.py's SCAN_STEPS: optimizer updates per call
TRAIN_LOSS_RTOL = 1e-4  # card against CPU: float32 sums over 64 x 4,096 pixels
TRAIN_GRAD_REL = 1e-4  # gradients: 1e-4·max|CPU| of each tensor
# params after N Adam steps (tests/torch_training_common.py): every element
# within 2·lr·N, all but 2e-5 of them within 1e-5; the rest are elements
# whose gradient is small against its running RMS, where Adam magnifies
# rounding differences (here: cuDNN's and the CPU's sums in another order)
TRAIN_PARAM_ATOL = 1e-5
TRAIN_FAR_SHARE = 2e-5
# bf16 compute, graph against eager: the same kernels on the same inputs,
# so they differ only where cuDNN sums in another order from run to run;
# the gradients reach the fp32 master weights through a bf16 cast, where
# such a difference can flip a rounding (2^-8 of the element), which moves
# the loss's bf16 logits more than fp32's: the loss is held within 1e-3,
# ten times the fp32 limit, and the params by the rule above
TRAIN_BF16_LOSS_RTOL = 1e-3
# the loss on 256 held-out images after 500 steps on dSprites must be below
# half its value at the start (predicting the background rate alone gives
# about 0.37 of the start, the sprites' pixels about 7 % of an image)
TRAIN_LEARN_MARGIN = 0.5


def params_apart(torch, got, want, n_steps):
  """(largest |difference|, elements beyond TRAIN_PARAM_ATOL, elements) of
  two {name: tensor} params after `n_steps` Adam steps; raises beyond the
  rule above."""
  worst, far, total = 0.0, 0, 0
  for k, w in want.items():
    d = (got[k].detach().cpu() - w.detach().cpu()).abs()
    worst = max(worst, float(d.max()))
    far += int((d > TRAIN_PARAM_ATOL).sum())
    total += d.numel()
  if worst > 2 * TRAIN_LR * n_steps + 1e-6 or far > TRAIN_FAR_SHARE * total:
    raise AssertionError(f"params {worst} apart at most, {far} of {total} "
                         f"elements beyond {TRAIN_PARAM_ATOL}")
  return worst, far, total


def train_flops(torch, vae, batch):
  """Model FLOPs of one training step at `batch`, counted from the layer
  shapes: 2 flops a multiply-add; the forward, the backward to the
  weights (as many) and the backward to the inputs (as many, except for
  the first layer, whose input is the data)."""
  from odin_tpu_torch.networks.base import Conv, ConvTranspose, Dense
  macs = []

  def hook(module, args, out):
    x = args[0]
    if isinstance(module, Dense):
      macs.append(x.numel() * module.units)
    elif isinstance(module, Conv):
      kh, kw = module.kernel_size
      macs.append(out.numel() * kh * kw * x.shape[-1])
    else:  # ConvTranspose: each input pixel scatters a kh x kw x out block
      kh, kw = module.kernel_size
      macs.append(x.numel() * kh * kw * module.filters)

  handles = [m.register_forward_hook(hook) for m in vae.core.modules()
             if isinstance(m, (Conv, ConvTranspose, Dense))]
  with torch.no_grad():
    x = torch.zeros(batch, 64, 64, 1, device=vae.device)
    vae.decode(vae.encode(x).mean())
  for h in handles:
    h.remove()
  fwd = 2.0 * sum(macs)
  return fwd + fwd + (fwd - 2.0 * macs[0]), fwd


def profile_steps(torch, fused, state, batches, eps):
  """Device time of one call of `fused` by kernel, from torch.profiler:
  (total device ms, [(name, ms)] largest first), or None where the trace
  holds no device time."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fused(state, batches, eps=eps)
    torch.cuda.synchronize()
  rows = []
  for e in prof.key_averages():
    if e.self_device_time_total > 0:
      rows.append((e.key, e.self_device_time_total / 1e3))
  rows.sort(key=lambda r: -r[1])
  total = sum(ms for _, ms in rows)
  return (total, rows) if total > 0 else None


def training_path(torch, np, reset_counts, read_counts, smi):
  """Phase 7: the beta-VAE training step on the card (see the docstring)."""
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.fuel import dSprites
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import device_dataset_steps, scan_steps

  cuda = torch.device("cuda", 0)
  B, lr = TRAIN_BATCH, TRAIN_LR

  def model(device):
    vae = BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10)).build(
        seed=1, device=device)
    return vae, vae.make_step_fn(learning_rate=lr, nan_policy="skip")

  def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out

  # -- 7.1 the card against the CPU: 3 steps, same batches and noise
  vae, step = model(cuda)
  vae_cpu, step_cpu = model("cpu")
  rs = np.random.RandomState(SEED)
  xs = (rs.rand(3, B, 64, 64, 1) < 0.5).astype(np.float32)
  epss = rs.randn(3, B, 10).astype(np.float32)
  _, _, g = step.value_and_grad(vae.state, xs[0],
                                eps=torch.from_numpy(epss[0]))
  _, _, g_cpu = step_cpu.value_and_grad(vae_cpu.state, xs[0],
                                        eps=torch.from_numpy(epss[0]))
  grad_rel = max(float((g["vae"][k].cpu() - w).abs().max() / w.abs().max())
                 for k, w in g_cpu["vae"].items())
  log(f"gradients of step 1, card against CPU: max |diff| / max |CPU| over "
      f"the {len(g_cpu['vae'])} tensors = {grad_rel:.3g} (limit "
      f"{TRAIN_GRAD_REL})")
  if not grad_rel <= TRAIN_GRAD_REL:
    raise AssertionError(f"gradients differ from the CPU by {grad_rel}")
  s, s_cpu = vae.state, vae_cpu.state
  reset_counts()
  for i in range(3):
    s, m = step(s, xs[i], eps=torch.from_numpy(epss[i]))
    s_cpu, m_cpu = step_cpu(s_cpu, xs[i], eps=torch.from_numpy(epss[i]))
    loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
    log(f"step {i + 1}: loss {loss:.4f} on the card, {loss_cpu:.4f} on the "
        f"CPU")
    if not (math.isfinite(loss) and
            abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)):
      raise AssertionError(f"step {i + 1} loss {loss} against {loss_cpu}")
  torch.cuda.synchronize()
  log(f"training path launches (the step runs cuDNN and cuBLAS, no kernel "
      f"of this port): {read_counts()}")
  worst, far, total = params_apart(torch, s.params["vae"],
                                   s_cpu.params["vae"], 3)
  log(f"params after 3 steps, card against CPU: max |diff| {worst:.3g}, "
      f"{far} of {total} beyond {TRAIN_PARAM_ATOL}")
  if int(s.step) != 3 or int(s.opt_states["vae"]["count"]) != 3:
    raise AssertionError("step or Adam count is not 3 after 3 steps")
  del vae_cpu, step_cpu, s_cpu

  # -- 7.2 graphed against eager on the card: 20 steps with cuDNN's
  # default (non-deterministic) algorithms, as the timed graphs run them.
  # The graph captures one step and replays it, so this k=20 graph holds
  # the same step as the timed k=500 graphs of 7.5.
  K = 20
  gen = torch.Generator(device=cuda).manual_seed(SEED)
  xk = (torch.rand(K, B, 64, 64, 1, device=cuda, generator=gen) < 0.5
        ).float()
  ek = torch.randn(K, B, 10, device=cuda, generator=gen)
  start = vae.state
  step16 = vae.make_step_fn(learning_rate=lr, compute_dtype=torch.bfloat16)
  for name, fn in (("bf16 compute", step16), ("fp32", step)):
    s_e = start
    for i in range(K):
      s_e, m_e = fn(s_e, xk[i], eps=ek[i])
      if i == 0:
        loss_1 = float(m_e["loss"])
    fused20 = scan_steps(fn, K)
    s_g, m_g = fused20(start, xk, eps=ek)
    torch.cuda.synchronize()
    loss_g, loss_e = float(m_g["loss"]), float(m_e["loss"])
    rtol = TRAIN_LOSS_RTOL if name == "fp32" else TRAIN_BF16_LOSS_RTOL
    worst, far, total = params_apart(torch, s_g.params["vae"],
                                     s_e.params["vae"], K)
    log(f"{K} steps {name}, CUDA graph against eager (cuDNN default "
        f"algorithms): loss at step {K} {loss_g:.6f} / {loss_e:.6f} (limit "
        f"rtol {rtol}; eager loss at step 1 {loss_1:.6f}), params max |diff| {worst:.3g} (limit "
        f"{2 * lr * K:.3g}), {far} of {total} beyond {TRAIN_PARAM_ATOL}; "
        f"capture {fused20.capture_seconds:.3f} s")
    if not (math.isfinite(loss_g) and
            abs(loss_g - loss_e) <= rtol * abs(loss_e)):
      raise AssertionError(f"graphed {name} loss {loss_g} against {loss_e}")
    if int(s_g.step) != K or int(s_g.skipped_updates) != 0:
      raise AssertionError(f"graphed state at step {int(s_g.step)}")

  # -- 7.3 NaN-skip on the card, eager and graphed
  bad = xk[:1].clone()
  bad[0, 3, 10, 20, 0] = float("nan")
  fused1 = scan_steps(step, 1)
  for name, (s_n, m_n) in (("eager", step(s_g, bad[0])),
                           ("graphed", fused1(s_g, bad))):
    torch.cuda.synchronize()
    same = all(torch.equal(s_n.params["vae"][k], v)
               for k, v in s_g.params["vae"].items())
    same &= all(torch.equal(s_n.opt_states["vae"][n]["vae"][k], v)
                for n in ("mu", "nu")
                for k, v in s_g.opt_states["vae"][n]["vae"].items())
    same &= torch.equal(s_n.opt_states["vae"]["count"],
                        s_g.opt_states["vae"]["count"])
    skipped = int(s_n.skipped_updates) - int(s_g.skipped_updates)
    log(f"NaN batch, {name}: loss {float(m_n['loss'])}, params and moments "
        f"unchanged {same}, skipped_updates +{skipped}, step "
        f"{int(s_g.step)} -> {int(s_n.step)}")
    if not same or skipped != 1 or int(s_n.step) != int(s_g.step) + 1:
      raise AssertionError(f"the {name} step did not skip a NaN batch")

  # where the device time goes: one call of the fp32 graph of 7.2 by kernel
  prof = profile_steps(torch, fused20, start, xk, ek)
  kernel_ms = None
  if prof is None:
    log("profile of 20 graphed steps: no device time in the trace (not "
        "measured)")
  else:
    total_ms, rows = prof
    kernel_ms = total_ms / K
    log(f"profile of {K} graphed steps: {kernel_ms:.3f} ms of kernels a "
        f"step; largest: " + "; ".join(
            f"{name[:60]} {ms / K:.3f} ms ({100 * ms / total_ms:.1f} %)"
            for name, ms in rows[:8]))
  del fused20, fused1, s_e, s_g, s_n, xk, ek

  # -- 7.4 learning on procedural dSprites resident on the card as uint8
  t0 = time.perf_counter()
  images = dSprites(n_samples=16384, seed=1).numpy("train", inc_labels=False)
  held = dSprites(n_samples=256, seed=1).numpy("valid", inc_labels=False)
  corpus = torch.from_numpy((images * 255).astype(np.uint8)).to(cuda)
  log(f"dSprites: {len(images)} images rendered and on the card as uint8 "
      f"({corpus.numel() / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s")
  vae2, step2 = model(cuda)
  eval_fn = vae2.make_eval_fn()
  before = float(eval_fn(vae2.state, held)["loss"])
  fd = device_dataset_steps(step2, B, TRAIN_STEPS, seed=SEED)
  reset_counts()
  t_first, (s_d, m_d) = sync_time(lambda: fd(vae2.state, corpus))
  log(f"device_dataset_steps launches: {read_counts()}")
  after = float(eval_fn(s_d, held)["loss"])
  log(f"held-out loss (256 images): {before:.2f} at step 0, {after:.2f} "
      f"after {TRAIN_STEPS} steps (limit {TRAIN_LEARN_MARGIN} x start); "
      f"last training loss {float(m_d['loss']):.2f}")
  if not (math.isfinite(after) and after < TRAIN_LEARN_MARGIN * before):
    raise AssertionError(f"the loss went from {before} to {after}")

  # -- 7.5 steps/s at batch 64
  flops, fwd_flops = train_flops(torch, vae, B)
  log(f"model FLOPs a training step at batch {B}: {flops / 1e9:.3f} G "
      f"(forward {fwd_flops / 1e9:.3f} G)")
  x500 = (torch.rand(TRAIN_STEPS, B, 64, 64, 1, device=cuda, generator=gen)
          < 0.5).float()

  def rate(name, steps, seconds, peak, capture=None):
    sps = steps / seconds
    share = flops * sps / peak
    log(f"train steps/s, {name}: {sps:.1f} ({1e3 / sps:.3f} ms a step; "
        f"{100 * share:.2f} % of {peak / 1e12:.0f} TFLOP/s)" +
        ("" if capture is None else f"; capture {capture:.3f} s"))

  s = start
  for i in range(3):  # warm-up
    s, _ = step(s, x500[i])
  n_eager = 50
  t, _ = sync_time(lambda: [step(start, x500[i]) for i in range(n_eager)])
  rate("eager, one step a call", n_eager, t, FP32_PEAK_FLOPS)

  def graphed(name, fn, state, data, k, peak):
    t_first, (st, _) = sync_time(lambda: fn(state, data))
    t, _ = sync_time(lambda: [fn(st, data) for _ in range(3)])
    rate(f"{name}, k={k}, 3 calls after one warm-up call", 3 * k, t, peak,
         capture=fn.capture_seconds)
    log(f"  first call {t_first:.3f} s (capture and {k} steps)")
    return t / (3 * k)

  t_step = graphed("scan_steps fp32", scan_steps(step, TRAIN_STEPS), start,
                   x500, TRAIN_STEPS, FP32_PEAK_FLOPS)
  if kernel_ms is not None:
    log(f"  the card is busy {100 * kernel_ms / (1e3 * t_step):.1f} % of a "
        f"graphed fp32 step ({kernel_ms:.3f} ms of kernels in the profile "
        f"against {1e3 * t_step:.3f} ms a step)")
  graphed("scan_steps bf16 compute", scan_steps(step16, TRAIN_STEPS),
          start, x500, TRAIN_STEPS, BF16_PEAK_FLOPS)
  t, _ = sync_time(lambda: fd(s_d, corpus))
  rate(f"device_dataset_steps fp32 (uint8 corpus), k={TRAIN_STEPS}, 1 call"
       f" after the learning call", TRAIN_STEPS, t, FP32_PEAK_FLOPS,
       capture=fd.capture_seconds)
  log(smi)
  return t_step


FIT_BATCH = 64  # the README quickstart's batch
# the quickstart's max_iter is 10,000; the phase runs these counts so that
# the whole script stays well inside its time limit
FIT_K1_STEPS = 300
FIT_K1_TIMED = 600
FIT_K = 100
FIT_STEPS = 1000
FIT_DD_CALL = 500


def fit_path(torch, np, reset_counts, read_counts, smi, graphed_s):
  """Phase 8: the README quickstart's training through the port's entry
  points (see the docstring)."""
  import os
  import pickle
  import shutil
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.fuel import dSprites, get_dataset
  from odin_tpu_torch.networks import get_networks

  cuda = torch.device("cuda", 0)
  B = FIT_BATCH
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      f"fit_path_{os.getpid()}")
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)

  def quickstart():
    return BetaVAE(beta=4.0, **get_networks("dsprites", zdim=10)).build()

  t0 = time.perf_counter()
  ds = get_dataset("dsprites")
  images, _ = ds.numpy("train")
  valid = dSprites(n_samples=256, seed=1).create_dataset(
      "valid", batch_size=B, epochs=1, shuffle=False, prefetch=0,
      to_device=cuda)
  held = dSprites(n_samples=256, seed=1).numpy("valid", inc_labels=False)
  log(f"get_dataset('dsprites'): {len(images)} procedural images rendered in "
      f"{time.perf_counter() - t0:.2f} s; validation: 256 images, 4 "
      f"batches on the card")

  def train():
    return ds.create_dataset("train", batch_size=B, epochs=-1, prefetch=2,
                             to_device=cuda)

  def records(logdir):
    with open(os.path.join(logdir, "log.jsonl")) as f:
      return [json.loads(line) for line in f]

  def same_state(a, b):
    from odin_tpu_torch.training import state_to_host
    ha, hb = state_to_host(a), state_to_host(b)
    bad = []

    def walk(x, y, path):
      if isinstance(x, dict):
        for k in x:
          walk(x[k], y[k], f"{path}/{k}")
      elif isinstance(x, torch.Tensor) and path != "/rng_state":
        if not torch.equal(x, y):
          bad.append(path)

    walk(ha, hb, "")
    return bad

  # -- 8.1 steps_per_call=1: a graph of one step a call, host batches
  # copied by the pipeline's thread; validation, logs, checkpoints
  reset_counts()
  vae = quickstart()
  logdir = os.path.join(root, "k1")
  tr = vae.fit(train(), valid=valid, max_iter=FIT_K1_STEPS, valid_freq=100,
               logdir=logdir, logging_interval=0.0, checkpoint_freq=100,
               steps_per_call=1, verbose=False)
  recs = records(logdir)
  train_steps = [r["step"] for r in recs if r["tag"] == "train"]
  valid_steps = [r["step"] for r in recs if r["tag"] == "valid"]
  log(f"fit k=1: {FIT_K1_STEPS} steps in {tr.total_time:.2f} s (capture "
      f"{tr.capture_seconds:.3f} s); log.jsonl: {len(train_steps)} train "
      f"records (steps 1..{train_steps[-1]}), valid at {valid_steps}")
  if train_steps != list(range(1, FIT_K1_STEPS + 1)) or \
      valid_steps != [100, 200, 300]:
    raise AssertionError(f"log.jsonl has train {train_steps[:5]}... and "
                         f"valid {valid_steps}")
  back = tr.restore_checkpoint()
  bad = same_state(back, vae.state)
  log(f"checkpoint at step {int(back.step)} restored: "
      f"{'bitwise equal to the state' if not bad else bad}")
  if bad or int(back.step) != FIT_K1_STEPS:
    raise AssertionError(f"the checkpoint differs from the state: {bad}")

  def timed(k, steps):
    """Seconds a step of a fit with no validation, no checkpoint and one
    record (the first), so that nothing syncs the host with the card
    between calls; the capture excluded."""
    tr_t = quickstart().fit(train(), max_iter=steps, steps_per_call=k,
                            logging_interval=1e9, verbose=False)
    return (tr_t.total_time - tr_t.capture_seconds) / steps

  k1_s = timed(1, FIT_K1_TIMED)

  # -- 8.2 steps_per_call=100 for 1000 steps: learning, logs, checkpoint
  vae2 = quickstart()
  eval_fn = vae2.make_eval_fn()
  before = float(eval_fn(vae2.state, held)["loss"])
  logdir = os.path.join(root, "k100")
  tr2 = vae2.fit(train(), valid=valid, max_iter=FIT_STEPS, valid_freq=500,
                 logdir=logdir, logging_interval=0.0, checkpoint_freq=500,
                 steps_per_call=FIT_K, verbose=False)
  after = float(eval_fn(vae2.state, held)["loss"])
  # a record every call reads the metrics, so the host waits for the
  # card's 100 steps before it gathers the next 100 batches
  k100_logged_s = (tr2.total_time - tr2.capture_seconds) / FIT_STEPS
  recs = records(logdir)
  train_steps = [r["step"] for r in recs if r["tag"] == "train"]
  valid_steps = [r["step"] for r in recs if r["tag"] == "valid"]
  log(f"fit k={FIT_K}: held-out loss (256 images) {before:.2f} at step 0, "
      f"{after:.2f} after {FIT_STEPS} steps (limit {TRAIN_LEARN_MARGIN} x "
      f"start); log.jsonl train at {train_steps}, valid at {valid_steps}; "
      f"capture {tr2.capture_seconds:.3f} s")
  if not (math.isfinite(after) and after < TRAIN_LEARN_MARGIN * before):
    raise AssertionError(f"the loss went from {before} to {after}")
  if train_steps != list(range(FIT_K, FIT_STEPS + 1, FIT_K)) or \
      valid_steps != [500, 1000]:
    raise AssertionError(f"log.jsonl has train {train_steps} and valid "
                         f"{valid_steps}")
  back = tr2.restore_checkpoint()
  bad = same_state(back, vae2.state)
  log(f"checkpoint at step {int(back.step)} restored: "
      f"{'bitwise equal to the state' if not bad else bad}")
  if bad or int(back.step) != FIT_STEPS:
    raise AssertionError(f"the checkpoint differs from the state: {bad}")

  k100_s = timed(FIT_K, FIT_STEPS)

  # -- 8.3 fit_device_dataset: 2 x 500 steps split by a checkpoint against
  # 1000 unbroken.  cuDNN's deterministic algorithms, so that both runs
  # run the same kernels on the same inputs: the draws are keyed by the
  # step count and the noise generator's state travels in the checkpoint,
  # so the two are equal bitwise
  corpus = (images * 255).astype(np.uint8)
  kw = dict(batch_size=B, steps_per_call=FIT_DD_CALL, seed=SEED,
            verbose=False)
  ckpt = os.path.join(root, "dd_checkpoint")
  torch.backends.cudnn.deterministic = True
  try:
    whole = quickstart().fit_device_dataset(corpus, n_steps=FIT_STEPS, **kw)
    first = quickstart().fit_device_dataset(
        corpus, n_steps=FIT_DD_CALL, checkpoint_path=ckpt,
        checkpoint_freq=FIT_DD_CALL, **kw)
    resumed = quickstart().load_weights(ckpt)
    resumed.fit_device_dataset(corpus, n_steps=FIT_STEPS - FIT_DD_CALL,
                               keep_opt_states=True, **kw)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  bad = same_state(resumed.state, whole.state)
  log(f"fit_device_dataset: {FIT_DD_CALL} steps, checkpoint, load_weights, "
      f"{FIT_STEPS - FIT_DD_CALL} more (keep_opt_states) against "
      f"{FIT_STEPS} unbroken, cuDNN deterministic: "
      f"{'bitwise equal' if not bad else f'{len(bad)} tensors differ'}; "
      f"step {int(resumed.state.step)}, the noise generator's state "
      f"{'equal' if torch.equal(resumed.state.rng.get_state(), whole.state.rng.get_state()) else 'differs'}")
  if bad or not torch.equal(resumed.state.rng.get_state(),
                            whole.state.rng.get_state()):
    raise AssertionError(f"the resumed run differs: {bad[:5]}")
  # its rate with cuDNN's default algorithms
  vae3 = quickstart()
  t0 = time.perf_counter()
  vae3.fit_device_dataset(corpus, n_steps=FIT_STEPS, **kw)
  torch.cuda.synchronize()
  dd_s = (time.perf_counter() - t0 - vae3.capture_seconds) / FIT_STEPS

  # -- 8.4 a host-fed step, split: the pipeline's host work, the pinned
  # copy, the graphed step
  pipe = ds.create_dataset("train", batch_size=B, epochs=-1, prefetch=0)
  it = iter(pipe)
  next(it)
  n = 50
  t0 = time.perf_counter()
  host = [next(it) for _ in range(n)]
  host_s = (time.perf_counter() - t0) / n
  pinned = torch.from_numpy(host[0]).pin_memory()
  dst = torch.empty(pinned.shape, device=cuda)
  copy_ms = cuda_ms(torch, lambda: dst.copy_(pinned, non_blocking=True))
  log(f"a host-fed step, split: pipeline on the host {1e3 * host_s:.3f} ms "
      f"a batch (the gather of {B} shuffled rows of 64 x 64 x 1 fp32), "
      f"pinned copy {copy_ms:.4f} ms ({pinned.numel() * 4 / 2**20:.2f} MiB; "
      f"CUDA events), graphed step {1e3 * graphed_s:.3f} ms (phase 7); "
      f"{smi}")
  for name, sec in (("fit steps_per_call=1", k1_s),
                    (f"fit steps_per_call={FIT_K}", k100_s),
                    (f"fit steps_per_call={FIT_K} with a record every "
                     f"call, validation and a checkpoint every 500 steps",
                     k100_logged_s),
                    (f"fit_device_dataset steps_per_call={FIT_DD_CALL}",
                     dd_s),
                    ("phase 7 scan_steps fp32 graphed", graphed_s)):
    log(f"{name}: {1 / sec:.1f} steps/s ({1e3 * sec:.3f} ms a step), "
        f"batch {B}, capture excluded; {smi}")
  torch.cuda.synchronize()
  log(f"fit path launches, all of phase 8 (the step runs cuDNN and cuBLAS, "
      f"no kernel of this port): {read_counts()}")
  shutil.rmtree(root, ignore_errors=True)
  return vae2


GYM_SAMPLES = 10000  # the README quickstart's run_model(n_samples=10000)
# the CPU side of the comparisons that take longest there (run_model, SAP,
# DCI, TC, FID) runs on the first rows only; PERF.md section 4 says so
GYM_CPU_ROWS = 2000
GYM_SCORES = ("elbo", "llk", "kl", "mig", "sap", "dci", "betavae",
              "factorvae", "tc", "active_units", "fid")
GYM_ZMEAN_ATOL = 1e-4  # card against CPU: cuDNN and the CPU sum apart
GYM_RTOL = 1e-4  # TC, kl_unweighted, the ELBO terms, FID on the same inputs


def gym_path(torch, np, reset_counts, read_counts, smi, vae):
  """Phase 10: the README quickstart's evaluation, ``DisentanglementGym
  (dataset=get_dataset('dsprites'), model=vae).run_model(n_samples=10000,
  partition='test')`` and ``write_report()`` with the default scores and
  FID, on the card, on phase 8's model; then the same model on the CPU
  (``z_mean`` of the first rows), each estimator on the CPU fed the card's
  own latents, and the time of ``run_model`` and of each score on both.
  Returns the card's Gym (phase 15 reads it)."""
  from odin_tpu_torch.bay.vi import BetaVAE, DisentanglementGym
  from odin_tpu_torch.fuel import get_dataset
  from odin_tpu_torch.networks import get_networks

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  t0 = time.perf_counter()
  ds = get_dataset("dsprites")
  ds.numpy("test")
  log(f"get_dataset('dsprites') test partition: "
      f"{time.perf_counter() - t0:.2f} s to render")

  def timed(fn):
    t = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    return out, time.perf_counter() - t

  # -- 10.1 the quickstart's lines on the card: the main path
  reset_counts()
  gym = DisentanglementGym(dataset=ds, model=vae)
  _, run_s = timed(lambda: gym.run_model(n_samples=GYM_SAMPLES,
                                         partition="test"))
  report, card_s, again_s = {}, {}, {}
  for score in GYM_SCORES:
    part, card_s[score] = timed(lambda: gym.write_report(scores=(score,)))
    report.update(part)
  counts = read_counts()
  # a second call of each: the first pays one-time costs (cuSOLVER's and
  # cuDNN's set-up, scipy's import)
  for score in GYM_SCORES:
    _, again_s[score] = timed(lambda: gym.write_report(scores=(score,)))
  log(f"gym path launches (run_model and write_report; the path runs "
      f"cuDNN, cuBLAS and torch's own kernels, none of this port's): "
      f"{counts}")
  errors = {k: v for k, v in report.items() if k.endswith("_error")}
  bad = [k for k, v in report.items() if not k.endswith("_error") and
         not math.isfinite(float(v))]
  log("write_report on the card: " + ", ".join(
      f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
      for k, v in report.items()))
  if errors or bad:
    raise AssertionError(f"write_report failed: {errors} {bad}")
  if gym.z_mean.device.type != "cuda" or gym.z_mean.shape != (GYM_SAMPLES,
                                                               10):
    raise AssertionError(f"z_mean {tuple(gym.z_mean.shape)} on "
                         f"{gym.z_mean.device}")

  # -- 10.2 the same model on the CPU: z_mean of the first rows
  cpu_vae = BetaVAE(beta=4.0, **get_networks("dsprites", zdim=10)).build(
      device="cpu")
  cpu_vae.core.load_state_dict({k: v.cpu() for k, v in
                                vae.core.state_dict().items()})
  cpu_gym = DisentanglementGym(dataset=ds, model=cpu_vae)
  # the ELBO's noise the card drew for every batch (its generator seeded
  # `seed`), given to the CPU
  eps = torch.randn((gym.batch_size, 10), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(gym.seed))
  _, cpu_run_s = timed(lambda: cpu_gym.run_model(
      n_samples=GYM_CPU_ROWS, partition="test", eps=eps.cpu()))
  dz = float((gym.z_mean[:GYM_CPU_ROWS].cpu() - cpu_gym.z_mean).abs().max())
  terms = []
  for name, card_v, cpu_v in (
      ("llk", gym.log_likelihood_values(), cpu_gym.log_likelihood_values()),
      ("kl", gym.kl_divergence_values(), cpu_gym.kl_divergence_values())):
    rel = float(((card_v[:GYM_CPU_ROWS].cpu() - cpu_v).abs() /
                 cpu_v.abs().clamp(min=1e-6)).max())
    terms.append((name, rel))
  log(f"run_model: card {GYM_SAMPLES} images in {run_s:.3f} s, CPU "
      f"{GYM_CPU_ROWS} in {cpu_run_s:.3f} s; first {GYM_CPU_ROWS} rows, "
      f"card against CPU: z_mean {dz:.3e} (limit {GYM_ZMEAN_ATOL}), " +
      ", ".join(f"{n} per sample rel {r:.3e}" for n, r in terms) +
      f" (limit {GYM_RTOL})")
  if not dz <= GYM_ZMEAN_ATOL or any(not r <= GYM_RTOL for _, r in terms):
    raise AssertionError(f"run_model differs from the CPU: z_mean {dz}, "
                         f"{terms}")

  # -- 10.3 each estimator on the CPU, fed the card's own latents
  def moved(device, rows=None):
    return moved_gym(gym, device, vae if device.type == "cuda" else cpu_vae,
                     rows)

  class CardDraws:
    """The card posterior's draws, handed to the CPU's scores: the seed
    each score draws seeds the same generator on the card."""

    def __init__(self, qz):
      self.qz = qz

    def mean(self):
      return self.qz.mean().cpu()

    def sample(self, sample_shape, generator):
      g = torch.Generator(cuda).manual_seed(generator.initial_seed())
      return self.qz.sample(sample_shape, generator=g).cpu()

  full_cpu = moved(cpu)
  small = {"card": moved(cuda, GYM_CPU_ROWS), "cpu": moved(cpu, GYM_CPU_ROWS)}
  n_test = math.ceil(0.2 * GYM_CPU_ROWS)
  n_test_full = math.ceil(0.2 * GYM_SAMPLES)
  checks = []  # (name, card, cpu, limit, card s, cpu s, rows on the CPU)

  def both(name, card_fn, cpu_fn, limit, rows):
    a, sa = timed(card_fn)
    b, sb = timed(cpu_fn)
    checks.append((name, a, b, limit, sa, sb, rows))

  for protocol in ("reference", "dlib"):
    both(f"mig ({protocol})", lambda: gym.mig_score(protocol),
         lambda: full_cpu.mig_score(protocol), 1e-10, GYM_SAMPLES)
    both(f"factorvae ({protocol})",
         lambda: gym.factorvae_score(protocol=protocol),
         lambda: _with_qz(full_cpu, CardDraws(gym.qz),
                          lambda: full_cpu.factorvae_score(
                              protocol=protocol)), 0.0, GYM_SAMPLES)
    n_votes = 2000 if protocol == "reference" else 5000
    both(f"betavae ({protocol})",
         lambda: gym.betavae_score(protocol=protocol),
         lambda: _with_qz(full_cpu, CardDraws(gym.qz),
                          lambda: full_cpu.betavae_score(protocol=protocol)),
         1.0 / n_votes, GYM_SAMPLES)
  both("sap", lambda: small["card"].sap_score(),
       lambda: small["cpu"].sap_score(), 2.0 / n_test, GYM_CPU_ROWS)
  both("dci", lambda: small["card"].dci_score(),
       lambda: small["cpu"].dci_score(), (1e-6, 1e-6, 1.0 / n_test),
       GYM_CPU_ROWS)
  both("total_correlation", small["card"].total_correlation,
       small["cpu"].total_correlation, GYM_RTOL, GYM_CPU_ROWS)
  both("kl_unweighted", gym.kl_unweighted, full_cpu.kl_unweighted, GYM_RTOL,
       GYM_SAMPLES)
  both("accuracy_score", gym.accuracy_score, full_cpu.accuracy_score,
       1.0 / n_test_full, GYM_SAMPLES)
  both("fid", lambda: small["card"].frechet_inception_distance(),
       lambda: small["cpu"].frechet_inception_distance(), GYM_RTOL,
       GYM_CPU_ROWS)
  failed = []
  for name, a, b, limit, sa, sb, rows in checks:
    a_t, b_t = np.atleast_1d(a), np.atleast_1d(b)
    lim = np.atleast_1d(limit)
    if name in ("total_correlation", "kl_unweighted", "fid"):
      ok = np.all(np.abs(a_t - b_t) <= lim * np.abs(b_t))
    else:
      ok = np.all(np.abs(a_t - b_t) <= lim + 1e-12)
    log(f"{name}: card {np.round(a_t, 6).tolist()} in {sa:.3f} s, CPU "
        f"{np.round(b_t, 6).tolist()} in {sb:.3f} s ({rows} rows on the "
        f"CPU), limit {np.atleast_1d(limit).tolist()}"
        f"{'' if ok else '  FAILED'}")
    if not ok:
      failed.append(name)
  log("gym scores on the card, write_report one score at a time, first "
      "call / second call (s): " + ", ".join(
          f"{k} {v:.3f} / {again_s[k]:.3f}" for k, v in card_s.items()) +
      f"; run_model {run_s:.3f}; {smi}")
  if failed:
    raise AssertionError(f"the card's Gym differs from the CPU: {failed}")
  return gym


def moved_gym(gym, device, model, rows=None):
  """A copy of a Gym with its run on `device` and `model`, cut to its first
  `rows` rows."""
  import copy
  from odin_tpu_torch.bay.helpers import map_distributions
  g = copy.copy(gym)
  take = (lambda t: t.to(device)) if rows is None else (
      lambda t: t[:rows].to(device))
  g.device = device
  g.model = model
  g.qz = map_distributions(take, gym.qz)
  g.px = map_distributions(take, gym.px)
  for name in ("_z_mean", "_z_discrete", "_factors_t", "_llk_total",
               "_kl_total"):
    setattr(g, name, take(getattr(gym, name)))
  if rows is not None:
    g.x_true = gym.x_true[:rows]
    g.groundtruth = copy.copy(gym.groundtruth)
    g.groundtruth.factors = gym.groundtruth.factors[:rows]
    g.groundtruth.factors_original = gym.groundtruth.factors_original[:rows]
  return g


def _with_qz(gym, qz, fn):
  """fn() with the Gym's posterior replaced by `qz` for its duration."""
  kept = gym.qz
  gym.qz = qz
  try:
    return fn()
  finally:
    gym.qz = kept


CLU_CPU_ROWS = GYM_CPU_ROWS  # the CPU side of phase 15's comparisons
CLU_BINS = 10  # discretizing's bins, and the naive-Bayes features'
CLU_KNN_TRAIN = 8000  # k-NN and naive Bayes: 8,000 train, 2,000 test rows
# KMeansJax at the GMM-UBM E-step's shape (BASELINE.md:42): 1M frames of 60
# dims, 512 clusters, drawn from a seeded 512-component Gaussian mixture
CLU_KM_ROWS, CLU_KM_DIM, CLU_KM_K, CLU_KM_ITERS = 1_000_000, 60, 512, 50
CLU_KM_SAMPLE = 65536  # rows whose labels are checked at full size
CLU_KM_CPU_ROWS, CLU_KM_CPU_K = 65536, 64  # card against CPU
CLU_SK_ROWS, CLU_SK_K = 100_000, 64  # fast_kmeans(framework="sklearn")
CLU_SCORE_ATOL = 1e-12  # ARI, AMI, NMI (tests/test_torch_gym_clustering.py)
CLU_ASW_ATOL = 1e-6  # silhouette
CLU_MI_ATOL = 1e-6  # the k-NN mutual information
CLU_LASSO_REL = 1e-6  # Lasso, of the largest coefficient
CLU_GMM_SHARE = 0.005  # gmm bins: rows that may differ
CLU_PLOT_ATOL = 1e-4  # plot data (tests/test_torch_gym_plots.py)
CLU_TSNE_ATOL = 1e-6  # t-SNE's P and one gradient (tests/test_torch_tsne.py)
CLU_CENTER_ATOL = 1e-5  # KMeansJax: each centre against its members' mean
CLU_INERTIA_RTOL = 1e-9  # KMeansJax: float64 inertia may not rise by more


def clustering_path(torch, np, reset_counts, read_counts, smi, gym):
  """Phase 15: the clustering path.  (a) On phase 10's Gym (10,000 test
  latents of phase 8's model): ``write_report`` with the default scores and
  'clustering', ``clustering_score`` of each factor, the 'lasso' and
  'mutualinfo' correlations and their relative strength,
  ``mutual_info_estimate``, ``discretizing`` in 10 bins by 'quantile',
  'kmeans' and 'gmm', the data of the ten plots and ``plot_latent_stats``
  (the t-SNE of all 10,000 latents, checked on the card by its KL and
  trustworthiness); each held against the port's CPU path fed the card's
  own latents on the first 2,000 rows.  (b) Classical ML: ``KMeansJax``
  (512 clusters, 50 iterations) on 1M x 60 frames of a seeded mixture drawn
  on the card, checked at full size and against the CPU at 65,536 rows and
  64 clusters; ``fast_kmeans(framework='sklearn')`` on 100,000 rows;
  ``fast_knn``, ``fast_dbscan``/``dbscan_predict`` and
  ``fast_naive_bayes`` on the latents, each against the CPU."""
  from odin_tpu_torch import ml
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.bay.vi import metrics as vim
  from odin_tpu_torch.bay.vi.utils import discretizing
  from odin_tpu_torch.ml import tsne
  from odin_tpu_torch.ml.neighbors import sq_distances
  from odin_tpu_torch.networks import get_networks

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  failed = []

  def timed(fn):
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t

  def hold(name, ok, detail):
    log(f"{name}: {detail}{'' if ok else '  FAILED'}")
    if not ok:
      failed.append(name)

  def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)

  def leaves(d):
    """The arrays of a plot's data, nested tuples and lists flattened."""
    if isinstance(d, (tuple, list)):
      return [a for x in d for a in leaves(x)]
    return [] if d is None else [np.asarray(host(d), np.float64)]

  def apart(a, b):
    return float(np.max(np.abs(host(a).astype(np.float64) -
                               host(b).astype(np.float64)))) \
        if np.size(host(a)) else 0.0

  reset_counts()
  z = gym.z_mean
  factors = gym._factors_t
  n, zdim = z.shape
  cpu_vae = BetaVAE(beta=4.0, **get_networks("dsprites", zdim=zdim)).build(
      device="cpu")
  cpu_vae.core.load_state_dict({k: v.cpu() for k, v in
                                gym.model.core.state_dict().items()})
  small = moved_gym(gym, cuda, gym.model, CLU_CPU_ROWS)
  small_cpu = moved_gym(gym, cpu, cpu_vae, CLU_CPU_ROWS)
  rows = CLU_CPU_ROWS

  # -- 15a the Gym's clustering path on the card, then the first rows on both
  report, s = timed(lambda: gym.write_report(scores=GYM_SCORES +
                                             ("clustering",)))
  errors = {k: v for k, v in report.items() if k.endswith("_error")}
  bad = [k for k, v in report.items() if not k.endswith("_error") and
         not math.isfinite(float(v))]
  hold("write_report with 'clustering'", not errors and not bad,
       f"{s:.3f} s; " + ", ".join(f"{k}={v:.6g}" for k, v in report.items()
                                  if k.startswith("clustering")) +
       f"{errors or ''}{bad or ''}")
  for i in range(factors.shape[1]):
    full, s = timed(lambda: gym.clustering_score(i))
    card, s_small = timed(lambda: small.clustering_score(i))
    want, s_cpu = timed(lambda: small_cpu.clustering_score(i))
    dev = max(abs(card[k] - want[k]) for k in ("ari", "ami", "nmi"))
    ok = (set(card) == set(want) and dev <= CLU_SCORE_ATOL and
          abs(card["asw"] - want["asw"]) <= CLU_ASW_ATOL and
          all(math.isfinite(v) for v in full.values()))
    hold(f"clustering_score({i}) ({int(torch.unique(factors[:, i]).numel())}"
         f" clusters)", ok,
         f"{n} rows on the card in {s:.3f} s "
         f"({', '.join(f'{k}={v:.6f}' for k, v in full.items())}); first "
         f"{rows}: card {s_small:.3f} s, CPU {s_cpu:.3f} s, ARI/AMI/NMI "
         f"apart {dev:.3e} (limit {CLU_SCORE_ATOL}), ASW apart "
         f"{abs(card['asw'] - want['asw']):.3e} (limit {CLU_ASW_ATOL})")
  for method in ("lasso", "mutualinfo"):
    mat, s = timed(lambda: gym.correlation_matrix(method))
    strength, s2 = timed(lambda: gym.relative_disentanglement_strength(
        method))
    card = small.correlation_matrix(method)
    want, s_cpu = timed(lambda: small_cpu.correlation_matrix(method))
    limit = (CLU_LASSO_REL * float(want.abs().max()) if method == "lasso"
             else CLU_MI_ATOL)
    hold(f"correlation_matrix({method!r})",
         apart(card, want) <= limit and bool(torch.isfinite(mat).all()),
         f"{tuple(mat.shape)} in {s:.3f} s, relative strength {strength:.6f}"
         f" in {s2:.3f} s; first {rows}: card against CPU "
         f"{apart(card, want):.3e} (limit {limit:.3e}), CPU {s_cpu:.3f} s")
  mi, s = timed(lambda: vim.mutual_info_estimate(z, factors))
  card = vim.mutual_info_estimate(z[:rows], factors[:rows])
  want = vim.mutual_info_estimate(z[:rows].cpu(), factors[:rows].cpu())
  hold("mutual_info_estimate", apart(card, want) <= CLU_MI_ATOL,
       f"{tuple(mi.shape)} in {s:.3f} s, max {float(mi.max()):.6f}; first "
       f"{rows}: card against CPU {apart(card, want):.3e} (limit "
       f"{CLU_MI_ATOL})")
  for strategy in ("quantile", "kmeans", "gmm"):
    bins, s = timed(lambda: discretizing(z, n_bins=CLU_BINS,
                                         strategy=strategy))
    card = discretizing(z[:rows], n_bins=CLU_BINS, strategy=strategy)
    want = discretizing(z[:rows].cpu(), n_bins=CLU_BINS, strategy=strategy)
    share = float((host(card) != host(want)).mean())
    limit = CLU_GMM_SHARE if strategy == "gmm" else 0.0
    hold(f"discretizing({strategy!r})", share <= limit and
         int(bins.max()) < CLU_BINS,
         f"{tuple(bins.shape)} in {s:.3f} s; first {rows}: rows apart "
         f"{share:.4%} (limit {limit:.1%})")

  # the plots' data: the full run on the card, then the first rows on both
  plot_args = {"reconstruction": (16,), "latents_traverse": (11, zdim, 1),
               "correlation": ("spearman",), "histogram": (40,),
               "distortion": (), "latents_stats": (),
               "interpolation": (0, 1, 10), "prior_sampling": (16,),
               "pairwise_scatter": (0, 6)}
  z_prior = gym.model.sample_prior(16, seed=gym.seed)
  for name, args in plot_args.items():
    extra = {"z": z_prior} if name == "prior_sampling" else {}
    data, s = timed(lambda: getattr(gym, f"_plot_data_{name}")(*args,
                                                               **extra))
    card = getattr(small, f"_plot_data_{name}")(*args, **extra)
    want = getattr(small_cpu, f"_plot_data_{name}")(*args, **{
        k: v.cpu() for k, v in extra.items()})
    worst = max(apart(a, b) for a, b in zip(leaves(card), leaves(want)))
    exact = name in ("histogram", "pairwise_scatter")
    hold(f"plot data {name}", worst <= (0.0 if exact else CLU_PLOT_ATOL) and
         all(np.isfinite(a).all() for a in leaves(data)),
         f"{s:.3f} s on the card ({n} rows); first {rows}: card against CPU "
         f"{worst:.3e} (limit {0.0 if exact else CLU_PLOT_ATOL})")
  (z2, colors), s = timed(lambda: gym._plot_data_latents_tsne(0))
  P = tsne.joint_probabilities_nn(z, 30.0)
  start = tsne._pca_init(z, 2)
  kl, _ = tsne.kl_divergence_grad(torch.as_tensor(z2, device=cuda), P)
  kl0, _ = tsne.kl_divergence_grad(start, P)
  trust, s_trust = timed(lambda: tsne.trustworthiness(z, z2, 5))
  trust0 = tsne.trustworthiness(z, start, 5)
  hold("t-SNE of the latents", z2.shape == (n, 2) and
       bool(np.isfinite(z2).all()) and float(kl) < float(kl0) and
       trust > trust0 and np.array_equal(colors, gym.groundtruth.factors[
           :, 0]),
       f"{n} rows (perplexity 30, 1000 iterations at most): {s:.3f} s; KL "
       f"{float(kl):.6f} (its PCA start {float(kl0):.6f}), "
       f"trustworthiness(k=5) {trust:.6f} in {s_trust:.3f} s (its PCA start "
       f"{trust0:.6f})")
  Pc = tsne.joint_probabilities_nn(z[:rows], 30.0)
  Pw = tsne.joint_probabilities_nn(z[:rows].cpu(), 30.0)
  y = tsne._pca_init(z[:rows], 2)
  _, gc = tsne.kl_divergence_grad(y.double(), Pc)
  _, gw = tsne.kl_divergence_grad(y.double().cpu(), Pw)
  dp = apart(Pc.to_dense(), Pw.to_dense())
  dg = apart(gc, gw) / max(float(gw.abs().max()), 1e-30)
  hold("t-SNE P and gradient", dp <= CLU_TSNE_ATOL and dg <= CLU_TSNE_ATOL,
       f"first {rows}: P card against CPU {dp:.3e}, gradient {dg:.3e} of "
       f"its largest (limit {CLU_TSNE_ATOL} each)")

  # -- 15b classical ML at a size users run
  gen = torch.Generator(cuda).manual_seed(SEED)
  means = 3.0 * torch.randn(CLU_KM_K, CLU_KM_DIM, device=cuda, generator=gen)
  comp = torch.randint(CLU_KM_K, (CLU_KM_ROWS,), device=cuda, generator=gen)
  frames = means[comp] + torch.randn(CLU_KM_ROWS, CLU_KM_DIM, device=cuda,
                                     generator=gen)
  del means, comp
  km, s_fit = timed(lambda: ml.KMeansJax(n_clusters=CLU_KM_K,
                                         n_iter=CLU_KM_ITERS).fit(frames))
  _, s_seed = timed(lambda: ml.KMeansJax(n_clusters=CLU_KM_K)._init_centers(
      frames, np.random.RandomState(1)))
  inert = [float(v) for v in km._inertias]
  rises = [b / a - 1 for a, b in zip(inert, inert[1:]) if b > a]
  pick = torch.randperm(CLU_KM_ROWS, device=cuda,
                        generator=gen)[:CLU_KM_SAMPLE]
  nearest = torch.argmin(sq_distances(frames[pick], km._last_centers), 1)
  label_ok = bool(torch.equal(nearest, km.labels_[pick]))
  counts = torch.bincount(km.labels_, minlength=CLU_KM_K)
  sums = torch.zeros(CLU_KM_K, CLU_KM_DIM, dtype=torch.float64,
                     device=cuda).index_add_(0, km.labels_, frames.double())
  member = (sums / counts.clamp(min=1)[:, None])[counts > 0]
  centre_dev = apart(member, km.cluster_centers_[counts > 0])
  lloyd_ms = 1e3 * (s_fit - s_seed) / km.n_iter_
  hold("KMeansJax at full size", label_ok and not [r for r in rises if r >
       CLU_INERTIA_RTOL] and centre_dev <= CLU_CENTER_ATOL,
       f"{CLU_KM_ROWS} x {CLU_KM_DIM} fp32, {CLU_KM_K} clusters: fit "
       f"{s_fit:.3f} s ({km.n_iter_} iterations), seeding {s_seed:.3f} s, "
       f"{lloyd_ms:.3f} ms a Lloyd iteration; inertia {inert[0]:.6g} -> "
       f"{inert[-1]:.6g}, largest rise {max(rises, default=0.0):.3e} "
       f"(limit {CLU_INERTIA_RTOL}); {CLU_KM_SAMPLE} labels the float64 "
       f"argmin: {label_ok}; centres against their members' means "
       f"{centre_dev:.3e} (limit {CLU_CENTER_ATOL}); {smi}")
  part = frames[:CLU_KM_CPU_ROWS]
  card, s_card = timed(lambda: ml.KMeansJax(n_clusters=CLU_KM_CPU_K).fit(
      part))
  want, s_cpu = timed(lambda: ml.KMeansJax(n_clusters=CLU_KM_CPU_K).fit(
      part.cpu()))
  hold("KMeansJax card against CPU",
       torch.equal(card.seed_indices_.cpu(), want.seed_indices_) and
       torch.equal(card.labels_.cpu(), want.labels_) and
       card.n_iter_ == want.n_iter_,
       f"{CLU_KM_CPU_ROWS} rows, {CLU_KM_CPU_K} clusters: seeds and labels "
       f"equal, {card.n_iter_} and {want.n_iter_} iterations, centres apart "
       f"{apart(card.cluster_centers_, want.cluster_centers_):.3e}; card "
       f"{s_card:.3f} s, CPU {s_cpu:.3f} s")
  sk, s = timed(lambda: ml.fast_kmeans(frames[:CLU_SK_ROWS],
                                       n_clusters=CLU_SK_K,
                                       framework="sklearn"))
  card = ml.fast_kmeans(frames[:rows], n_clusters=CLU_SK_K,
                        framework="sklearn")
  want = ml.fast_kmeans(frames[:rows].cpu(), n_clusters=CLU_SK_K,
                        framework="sklearn")
  hold("fast_kmeans(framework='sklearn')",
       torch.equal(card.labels_.cpu(), want.labels_) and
       card.n_iter_ == want.n_iter_,
       f"the first {CLU_SK_ROWS} frames, {CLU_SK_K} clusters, n_init 4: "
       f"{s:.3f} s, inertia {sk.inertia_:.6g}; first {rows}: labels "
       f"equal, {card.n_iter_} and {want.n_iter_} iterations")
  del frames, part
  train, test = slice(0, CLU_KNN_TRAIN), slice(CLU_KNN_TRAIN, n)
  y0 = factors[:, 0]
  knn, s = timed(lambda: ml.fast_knn(z[train], y0[train], n_neighbors=5))
  pred, s2 = timed(lambda: knn.predict(z[test]))
  want = ml.fast_knn(z[train].cpu(), y0[train].cpu(),
                     n_neighbors=5).predict(z[test].cpu())
  hold("fast_knn", torch.equal(pred.cpu(), want),
       f"fit {s:.3f} s, predict {s2:.3f} s ({pred.numel()} rows, accuracy "
       f"{float((pred == y0[test]).double().mean()):.4f}); CPU predictions "
       f"equal")
  eps = float(torch.median(ml.fast_knn(z, n_neighbors=5).kneighbors()[0][
      :, -1]))
  db, s = timed(lambda: ml.fast_dbscan(z, eps=eps, min_samples=5))
  db8, s2 = timed(lambda: ml.fast_dbscan(z[train], eps=eps, min_samples=5))
  held, s3 = timed(lambda: ml.dbscan_predict(db8, z[test]))
  card = ml.fast_dbscan(z[:rows], eps=eps, min_samples=5)
  want = ml.fast_dbscan(z[:rows].cpu(), eps=eps, min_samples=5)
  probe = z[rows:2 * rows]
  hold("fast_dbscan and dbscan_predict",
       torch.equal(card.labels_.cpu(), want.labels_) and
       torch.equal(card.core_sample_indices_.cpu(),
                   want.core_sample_indices_) and
       torch.equal(ml.dbscan_predict(card, probe).cpu(),
                   ml.dbscan_predict(want, probe.cpu())),
       f"eps {eps:.6f} (the median 5-NN distance): {n} rows in {s:.3f} s, "
       f"{int(db.labels_.max()) + 1} clusters, "
       f"{db.core_sample_indices_.numel()} cores, "
       f"{int((db.labels_ < 0).sum())} noise; the first "
       f"{CLU_KNN_TRAIN} in {s2:.3f} s, dbscan_predict of the other "
       f"{held.numel()} in {s3:.3f} s; first {rows} and the next {rows} "
       f"predicted: card and CPU equal")
  codes = discretizing(z, n_bins=CLU_BINS)
  for dist in ("categorical", "multinomial", "bernoulli"):
    nb, s = timed(lambda: ml.fast_naive_bayes(codes[train], y0[train], dist))
    pred = nb.predict(codes[test])
    want = ml.fast_naive_bayes(codes[train].cpu(), y0[train].cpu(),
                               dist).predict(codes[test].cpu())
    hold(f"fast_naive_bayes({dist!r})", torch.equal(pred.cpu(), want),
         f"fit {s:.3f} s, accuracy "
         f"{float((pred == y0[test]).double().mean()):.4f}; CPU predictions "
         f"equal")
  log(f"clustering path launches (the path runs cuBLAS and torch's own "
      f"kernels, none of this port's): {read_counts()}")
  if failed:
    raise AssertionError(f"the clustering path failed: {failed}")


CORPUS_SR = 16000  # benchmarks/corpus_extraction_bench.py:32-34: 16 kHz, 8 s
CORPUS_SECONDS = 8.0
CORPUS_SPEAKERS = 64  # cut from the bench's 64 x 64 utterances
CORPUS_UTTERANCES = 32
CORPUS_BATCH = 64
CORPUS_FEATURES = ("mspec", "mfcc_cmvn", "vad")
CORPUS_CPU_FILES = 128  # held against the port on the CPU
CORPUS_F16_FILES = 512  # the float16 transfer
CORPUS_LOADER_FILES = 256  # AudioFeatureLoader
CMVN_TOL = 5e-3  # tests/test_preprocessing.py:382, batch padding differs
F16_RTOL, F16_ATOL = 2e-3, 2e-2  # tests/test_preprocessing.py:406
VAD_SHARE = 0.999
PCA_COMPONENTS = 20
PCA_ATOL, PCA_RTOL = 1e-4, 1e-4
STREAM_CHUNK = 1600  # 0.1 s at 16 kHz: 80 chunks a stream of 8 s
# tests/test_ops_features.py:168-176, rtol 1e-4 beside each
STREAM_LIMITS = (("spec", 1e-5), ("mspec", 1e-4), ("mfcc", 1e-4),
                 ("energy", 1e-4), ("mspec_cmvn", 1e-3), ("mfcc_cmvn", 1e-3))
# Griffin-Lim: Tacotron's framing at 16 kHz (50 ms frames, 12.5 ms hop)
GL_FRAME, GL_HOP, GL_ITERS, GL_SECONDS = 800, 200, 32, 2.0
GL_CPU_TOL = 1e-3
GL_LIMIT = 0.15  # tests/test_ops_features.py:207-227


def corpus_root():
  import os
  return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "corpus_path")


def write_corpus(root):
  """The corpus of phase 9, written by a child process while phases 2-8
  run: the port's synthetic speaker corpus (64 speakers x 32 utterances of
  8 s at 16 kHz), each utterance cut to a length drawn from 4-8 s with
  numpy seed 0, as int16 wav files, and the first 64 uncut as int16
  streams.  Needs no card."""
  import os
  import numpy as np
  from odin_tpu_torch.fuel.audio_data import synth_speaker_corpus
  from odin_tpu_torch.preprocessing.speech import save_wave
  t0 = time.perf_counter()
  utts, _ = synth_speaker_corpus(CORPUS_SPEAKERS, CORPUS_UTTERANCES, seed=0,
                                 sr=CORPUS_SR, dur=CORPUS_SECONDS)
  t_synth = time.perf_counter() - t0
  lengths = np.random.RandomState(0).randint(
      int(4 * CORPUS_SR), int(CORPUS_SECONDS * CORPUS_SR) + 1, len(utts))
  wav = os.path.join(root, "wav")
  os.makedirs(wav)
  for i, (y, n) in enumerate(zip(utts, lengths)):
    save_wave(os.path.join(wav, f"s{i // CORPUS_UTTERANCES:02d}_"
                                f"u{i % CORPUS_UTTERANCES:02d}.wav"),
              y[:n], CORPUS_SR)
  streams = np.round(np.clip(np.stack(utts[:64]), -1, 1) * 32767.0)
  np.save(os.path.join(root, "streams.npy"), streams.astype(np.int16))
  with open(os.path.join(root, "written.json"), "w") as f:
    json.dump({"synth_s": t_synth, "total_s": time.perf_counter() - t0}, f)


def start_corpus_writer():
  import os
  import shutil
  root = corpus_root()
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                           "--write-corpus", root])


def corpus_path(torch, np, reset_counts, read_counts, smi, writer):
  """Phase 9: corpus extraction, the AudioFeatureLoader, streaming features
  and Griffin-Lim on the card (see the docstring)."""
  import glob
  import os
  import shutil
  from odin_tpu_torch.fuel import AudioFeatureLoader, Dataset
  from odin_tpu_torch.ops import inversion, streaming_features as sf
  from odin_tpu_torch.ops.features import FeatureConfig, speech_features
  from odin_tpu_torch.preprocessing import (DeviceCorpusProcessor,
                                            batch_speech_features,
                                            calculate_pca, validate_features)
  from odin_tpu_torch.preprocessing.speech import read_wave_raw

  cuda = torch.device("cuda", 0)
  cfg = FeatureConfig(sr=CORPUS_SR)
  root = corpus_root()
  t0 = time.perf_counter()
  if writer.wait(timeout=600) != 0:
    raise RuntimeError(f"the corpus writer exited with {writer.returncode}")
  with open(os.path.join(root, "written.json")) as f:
    written = json.load(f)
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
  n_files = CORPUS_SPEAKERS * CORPUS_UTTERANCES
  if len(files) != n_files:
    raise AssertionError(f"{len(files)} wav files, not {n_files}")
  raw = [read_wave_raw(f)[0] for f in files]
  n_samples = np.array([len(y) for y in raw])
  audio_s = float(n_samples.sum()) / CORPUS_SR
  n_bytes = sum(os.path.getsize(f) for f in files)
  log(f"corpus: {n_files} int16 wav files ({CORPUS_SPEAKERS} speakers x "
      f"{CORPUS_UTTERANCES} utterances, cut to 4-8 s), {audio_s / 3600:.3f} "
      f"h of audio, {n_bytes / 1e6:.1f} MB; written by a child process in "
      f"{written['total_s']:.2f} s (synthesis {written['synth_s']:.2f} s) "
      f"while phases 2-8 ran; waited {time.perf_counter() - t0:.2f} s")

  def rates(name, ds, n, seconds_of_audio):
    a = ds.attrs
    wall = a["wallclock_sec"]
    shares = ", ".join(f"{k} {v:.4f} s ({100 * v / wall:.1f} %)"
                       for k, v in a["phase_sec"].items())
    batches = -(-n // CORPUS_BATCH)
    log(f"{name}: {n} files in {wall:.4f} s: {n / wall:.1f} files/s, "
        f"{a['frames'] / wall:.1f} valid frames/s, "
        f"{seconds_of_audio / wall:.1f} s of audio per second, "
        f"{1e3 * wall / batches:.3f} ms a batch of {CORPUS_BATCH}; "
        f"phase_sec: {shares}; {smi}")

  def rows(ds, feat, n):
    """The store's rows of `feat` for its first `n` files, in file order."""
    idx = ds[f"indices_{feat}"]
    end = max(idx[os.path.basename(f)][1] for f in files[:n])
    return np.asarray(ds[feat][:end])

  def agree(name, got, want):
    """Two stores' mspec, mfcc_cmvn and vad rows: 0.01 dB, 5e-3, 99.9 %."""
    e_mspec = float(np.abs(got["mspec"] - want["mspec"]).max())
    cmvn_ok = np.allclose(got["mfcc_cmvn"], want["mfcc_cmvn"], rtol=CMVN_TOL,
                          atol=CMVN_TOL)
    e_cmvn = float(np.abs(got["mfcc_cmvn"] - want["mfcc_cmvn"]).max())
    vad = float((got["vad"].ravel() == want["vad"].ravel()).mean())
    log(f"{name}: mspec max diff {e_mspec:.6f} dB (limit {LOGMEL_TOL_DB}), "
        f"mfcc_cmvn max diff {e_cmvn:.3g} (rtol {CMVN_TOL}, atol "
        f"{CMVN_TOL}), vad agreement {vad:.6f} of "
        f"{got['vad'].size} frames (limit {VAD_SHARE})")
    if not (e_mspec <= LOGMEL_TOL_DB and cmvn_ok and vad >= VAD_SHARE):
      raise AssertionError(f"{name}: the stores disagree")

  # -- 9.1 DeviceCorpusProcessor on the card
  store = os.path.join(root, "store")
  reset_counts()
  ds = DeviceCorpusProcessor(files, store, features=CORPUS_FEATURES,
                             batch_size=CORPUS_BATCH, device="cuda").run()
  counts = read_counts()
  n_batches = -(-n_files // CORPUS_BATCH)
  log(f"corpus path launches ({n_batches} batches): {counts}")
  if counts["logmel"] != n_batches or counts["logmel_fft"] != n_batches:
    raise AssertionError(f"the corpus path launched K1 {counts}, not once a "
                         f"batch ({n_batches})")
  rates("DeviceCorpusProcessor float32", ds, n_files, audio_s)

  # the indices: each utterance's rows are n_frames of its length, in order
  expected = cfg.n_frames(n_samples)
  for feat in CORPUS_FEATURES:
    idx = ds[f"indices_{feat}"]
    spans = np.array([idx[os.path.basename(f)] for f in files])
    if not (np.array_equal(spans[:, 1] - spans[:, 0], expected) and
            np.array_equal(spans[1:, 0], spans[:-1, 1]) and
            spans[0, 0] == 0 and spans[-1, 1] == len(ds[feat])):
      raise AssertionError(f"indices_{feat} do not count each utterance's "
                           "frames")
  store_rows = {k: np.asarray(ds[k][:]) for k in CORPUS_FEATURES}
  # the sums: the float64 sums of the stored rows
  for feat in ("mspec", "mfcc_cmvn"):
    r = store_rows[feat].astype(np.float64)
    for i, want in ((1, r.sum(0)), (2, (r ** 2).sum(0))):
      got = ds[f"{feat}_sum{i}"]
      if not np.allclose(got, want, rtol=1e-9, atol=1e-6):
        raise AssertionError(f"{feat}_sum{i} is not the sum of the rows")
  log(f"indices: {len(files)} utterances, {len(store_rows['mspec'])} rows, "
      f"each n_frames of its length; sum1/sum2 equal the float64 sums of "
      "the rows (rtol 1e-9)")

  # against batch_speech_features on the card, every utterance
  ref = batch_speech_features(raw, cfg, batch_size=CORPUS_BATCH,
                              features=CORPUS_FEATURES, device="cuda")
  agree("store against batch_speech_features on the card, every utterance",
        store_rows, {k: np.concatenate([r[k] for r in ref])
                     for k in CORPUS_FEATURES})
  del ref
  # against the port on the CPU, the first files
  t1 = time.perf_counter()
  cpu = DeviceCorpusProcessor(files[:CORPUS_CPU_FILES],
                              os.path.join(root, "cpu"),
                              features=CORPUS_FEATURES,
                              batch_size=CORPUS_BATCH, device="cpu").run()
  log(f"the same on the CPU, {CORPUS_CPU_FILES} files: "
      f"{time.perf_counter() - t1:.2f} s")
  agree(f"store against the CPU's, the first {CORPUS_CPU_FILES} files",
        {k: rows(ds, k, CORPUS_CPU_FILES) for k in CORPUS_FEATURES},
        {k: np.asarray(cpu[k][:]) for k in CORPUS_FEATURES})
  # the float16 transfer
  f16 = DeviceCorpusProcessor(files[:CORPUS_F16_FILES],
                              os.path.join(root, "f16"),
                              features=CORPUS_FEATURES,
                              batch_size=CORPUS_BATCH,
                              transfer_dtype="float16", device="cuda").run()
  rates("DeviceCorpusProcessor float16 transfer", f16, CORPUS_F16_FILES,
        float(n_samples[:CORPUS_F16_FILES].sum()) / CORPUS_SR)
  for feat in ("mspec", "mfcc_cmvn"):
    got, want = np.asarray(f16[feat][:]), rows(ds, feat, CORPUS_F16_FILES)
    e = float(np.abs(got - want).max())
    log(f"float16 transfer {feat}: max diff {e:.4g} from float32 (rtol "
        f"{F16_RTOL}, atol {F16_ATOL})")
    if got.dtype != np.float32 or not np.allclose(got, want, rtol=F16_RTOL,
                                                  atol=F16_ATOL):
      raise AssertionError(f"the float16 transfer's {feat} is off")

  # -- 9.2 validate_features and calculate_pca
  report = validate_features(store, "mspec")
  log(f"validate_features: {report}")
  if report["n_nan"] or report["n_inf"] or report["n_utterances"] != n_files:
    raise AssertionError(f"validate_features: {report}")
  pcas = {}
  for device in ("cuda", "cpu"):
    t1 = time.perf_counter()
    pcas[device] = calculate_pca(store, "mspec",
                                 n_components=PCA_COMPONENTS, device=device)
    log(f"calculate_pca on {device}: {time.perf_counter() - t1:.3f} s for "
        f"{pcas[device].n_samples_seen_} rows x 40 in chunks of 8192")
  card, host = pcas["cuda"], pcas["cpu"]
  e_comp = float(np.abs(card.components_ - host.components_).max())
  ev_ok = np.allclose(card.explained_variance_, host.explained_variance_,
                      rtol=PCA_RTOL, atol=0)
  log(f"PCA card against CPU: components max diff {e_comp:.3g} (limit "
      f"{PCA_ATOL}), explained variance within rtol {PCA_RTOL}: {ev_ok}; "
      f"explained variance ratio of {PCA_COMPONENTS} components "
      f"{float(card.explained_variance_ratio_.sum()):.6f}")
  if not (e_comp <= PCA_ATOL and ev_ok):
    raise AssertionError("calculate_pca on the card differs from the CPU")
  del store_rows

  # -- 9.3 AudioFeatureLoader
  sub = files[:CORPUS_LOADER_FILES]
  for compat, feature, atol, rtol in (("odin", "mspec", LOGMEL_TOL_DB, 0.0),
                                      ("tf", "mels", 2e-3, 1e-4)):
    kw = dict(sr=CORPUS_SR, feature=feature, compat=compat,
              max_duration=CORPUS_SECONDS)
    reset_counts()
    t1 = time.perf_counter()
    got = AudioFeatureLoader(sub, device="cuda", **kw).numpy(
        "all", inc_labels=False)
    t_card = time.perf_counter() - t1
    counts = read_counts()
    want = AudioFeatureLoader(sub, device="cpu", **kw).numpy(
        "all", inc_labels=False)
    e = float(np.abs(got - want).max())
    log(f"AudioFeatureLoader compat={compat} {feature} {got.shape}: "
        f"{t_card:.3f} s on the card (decode included), max diff from the "
        f"CPU {e:.4g} (rtol {rtol}, atol {atol}); launches {counts}")
    want_launches = -(-CORPUS_LOADER_FILES // 64) if compat == "odin" else 0
    if counts["logmel"] != want_launches or \
        counts["logmel_fft"] != want_launches:
      raise AssertionError(f"the loader launched K1 {counts}, not "
                           f"{want_launches} times")
    if not np.allclose(got, want, rtol=rtol, atol=atol):
      raise AssertionError(f"AudioFeatureLoader compat={compat} differs "
                           "from the CPU")

  # -- 9.4 streaming: 64 streams of 8 s in chunks of 0.1 s
  streams = np.load(os.path.join(root, "streams.npy"))
  B, T = streams.shape
  n_chunks = T // STREAM_CHUNK

  def stream(timed):
    state = sf.streaming_init(cfg, B, device="cuda")
    outs, lat = [], []
    for k in range(n_chunks):
      t1 = time.perf_counter()
      state, out = sf.streaming_step(
          cfg, state, streams[:, k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK])
      out["mspec_raw"].cpu()  # the chunk's log-mels back on the host
      lat.append(time.perf_counter() - t1)
      if not timed:
        outs.append(out)
    return state, outs, lat

  state, outs, _ = stream(False)
  fin = sf.streaming_finalize(cfg, state, outs)
  offline = speech_features(streams, cfg, device="cuda", use_pallas=False)
  lead = sf.carry_samples(cfg) // cfg.step_length
  F = offline["mspec"].shape[1]
  mask = fin["frame_mask"].cpu().numpy()
  if mask[:, :lead].any() or not mask[:, lead:lead + F].all():
    raise AssertionError("streaming: the frame mask is off")
  errs = {}
  for key, atol in STREAM_LIMITS:
    a = fin[key][:, lead:lead + F].cpu().numpy()
    b = offline[key].cpu().numpy()
    errs[key] = float(np.abs(a - b).max())
    if not np.allclose(a, b, rtol=1e-4, atol=atol):
      raise AssertionError(f"streaming {key} differs from offline by "
                           f"{errs[key]}")
  vad_equal = np.array_equal(fin["vad"][:, lead:lead + F].cpu().numpy(),
                             offline["vad"].cpu().numpy())
  log(f"streaming ({B} streams, {n_chunks} chunks of {STREAM_CHUNK} "
      f"samples) against offline speech_features(use_pallas=False) on the "
      f"card, max diff: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      errs.items()) + f"; vad equal: "
      f"{vad_equal}")
  if not vad_equal:
    raise AssertionError("the streaming VAD differs from the offline VAD")
  lat = sorted(sum((stream(True)[2] for _ in range(3)), []))
  log(f"streaming chunk latency, host to host ({len(lat)} chunks of 0.1 s "
      f"for {B} streams): median {1e3 * lat[len(lat) // 2]:.3f} ms, p99 "
      f"{1e3 * lat[int(0.99 * len(lat))]:.3f} ms; real-time factor "
      f"{sum(lat) / 3 / (T / CORPUS_SR):.5f} (processing s per s of "
      f"audio, all {B} streams together); {smi}")

  # -- 9.5 Griffin-Lim
  y = streams[:, :int(GL_SECONDS * CORPUS_SR)].astype(np.float32) / 32768.0
  re, im = inversion.stft_device(y, GL_FRAME, GL_HOP, device="cpu")
  mag = torch.sqrt(re * re + im * im)
  phase = torch.rand(mag.shape, generator=torch.Generator().manual_seed(SEED))
  phase = phase * (2 * math.pi)

  def convergence(device):
    m = mag.to(device)
    t1 = time.perf_counter()
    rec = inversion.griffin_lim_device(m, GL_FRAME, GL_HOP, GL_ITERS,
                                       init_phase=phase, device=device)
    if device == "cuda":
      torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    r2, i2 = inversion.stft_device(rec, GL_FRAME, GL_HOP, device=device)
    m2 = torch.sqrt(r2 * r2 + i2 * i2)[:, :m.shape[1]]
    return float(torch.linalg.norm(m2 - m) / torch.linalg.norm(m)), seconds

  convergence("cuda")  # warm-up
  sc_card, t_card = convergence("cuda")
  sc_cpu, t_cpu = convergence("cpu")
  log(f"Griffin-Lim, {B} utterances of {GL_SECONDS} s, frames {GL_FRAME} "
      f"hop {GL_HOP}, {GL_ITERS} iterations: spectral convergence "
      f"{sc_card:.6f} on the card, {sc_cpu:.6f} on the CPU (limits: within "
      f"{GL_CPU_TOL}, below {GL_LIMIT}); {1e3 * t_card:.3f} ms on the card, "
      f"{1e3 * t_cpu:.3f} ms on the CPU; {smi}")
  if abs(sc_card - sc_cpu) > GL_CPU_TOL or not sc_card < GL_LIMIT:
    raise AssertionError("Griffin-Lim on the card does not converge as on "
                         "the CPU")
  # the wav files stay for phase 11, which removes the corpus at its end
  for name in ("store", "cpu", "f16"):
    shutil.rmtree(os.path.join(root, name), ignore_errors=True)


# phase 11: the README's speaker quickstart on phase 9's wav files
SPK_NMIX = 512  # BASELINE.md:42, the JAX package's measured UBM
SPK_TV_DIM = 100  # Ivector's default and the README's
SPK_TMAT_ITERS = 10
SPK_TRAIN = 20  # utterances 0-19 of each speaker train, 20-31 test
SPK_PLDA = dict(n_phi=16, n_iter=8)  # examples/tidigits/ivec.py:58-59
SPK_CPU_FILES = 128  # the card held against the port on the CPU
# card against CPU from the same state, each over the CPU value's largest
# magnitude.  The card's fp32 sums and the CPU's each lie about as far
# from float64 as tools/speaker_recipe.py prints for the CPU at nmix 64 on
# these files (GMM E-step and transform_batch 2e-7 to 8.1e-7, T-matrix
# E-step and i-vectors 9.1e-7 to 2.3e-6); the limits are about 100x that:
SPK_GMM_TOL = 1e-4  # GMM E-step and transform_batch: fp32 posteriors
SPK_TMAT_TOL = 3e-4  # T-matrix E-step and i-vectors: fp32 Cholesky solves
# cosine scores and PLDA llrs fitted on both in float64: i-vectors moved
# by 2^-50 move the llrs by 2.1e-11 of their largest (the cosine scores
# 1.7e-15); 1e-9 is 50x that
SPK_SCORE_TOL = 1e-9
# the recipe learns: limits fixed from the port's CPU run of the same
# recipe at nmix 64 on the same files, before the first card run
# (tools/speaker_recipe.py --nmix 64: cosine EER 0.1343, PLDA accuracy
# 0.4219; chance is 0.5 and 1/64): the EER at most 1.5x the CPU's, the
# accuracy at least half of it
SPK_COSINE_EER_MAX = 0.2015
SPK_PLDA_ACC_MIN = 0.2109
# the E-step timed alone: BASELINE.md:42's 512 mixtures x 60 dims, 1M frames
ESTEP_FRAMES, ESTEP_NMIX, ESTEP_DIM = 1_000_000, 512, 60


def speaker_recipe(torch, np, files, device, nmix, path=None):
  """The README's speaker lines on `device` over phase 9's wav files
  (``sXX_uYY.wav``: speaker XX; utterances 0-19 train, 20-31 test):
  ``batch_speech_features(raw, features=("mfcc_cmvn",))``,
  ``Ivector(nmix, tv_dim=100).fit_transform`` on the train split and
  ``transform`` on the test split, ``Scorer(method="cosine", wccn=True)``
  against the speakers' models (EER, minDCF, closed-set accuracy), and
  ``PLDA(n_phi=16, n_iter=8)``'s test x test ``score_matrix`` off the
  diagonal (EER) and ``predict`` (accuracy).  Returns the results, the
  fitted objects and the seconds of each stage; the GMM's and the
  T-matrix's methods are timed through wrappers that synchronise."""
  import os
  import re
  from odin_tpu_torch.backend import compute_EER, compute_minDCF, det_curve
  from odin_tpu_torch.ml import PLDA, Ivector, Scorer
  from odin_tpu_torch.preprocessing import batch_speech_features
  from odin_tpu_torch.preprocessing.speech import read_wave_raw

  sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
  ids = [re.match(r"s(\d+)_u(\d+)\.wav$", os.path.basename(f)).groups()
         for f in files]
  spk = np.array([int(s) for s, _ in ids])
  train = np.array([int(u) < SPK_TRAIN for _, u in ids])
  t0 = time.perf_counter()
  raw = [read_wave_raw(f)[0] for f in files]
  out = {"read_s": time.perf_counter() - t0, "calls": {}}

  def timed(obj, prefix, name):
    fn = getattr(obj, name)

    def call(*args, **kwargs):
      sync()
      t = time.perf_counter()
      result = fn(*args, **kwargs)
      sync()
      out["calls"].setdefault(f"{prefix}.{name}", []).append(
          time.perf_counter() - t)
      return result
    setattr(obj, name, call)

  def stage(name, fn):
    sync()
    t = time.perf_counter()
    result = fn()
    sync()
    out[name + "_s"] = time.perf_counter() - t
    return result

  t0 = time.perf_counter()
  feats = stage("features", lambda: [f["mfcc_cmvn"] for f in
                                     batch_speech_features(
                                         raw, features=("mfcc_cmvn",),
                                         device=device)])
  ivec = Ivector(path=path, nmix=nmix, tv_dim=SPK_TV_DIM,
                 niter_tmat=SPK_TMAT_ITERS, device=device)
  for obj, prefix, names in (
      (ivec.gmm, "gmm", ("fit", "expectation", "transform_batch")),
      (ivec.tmat, "tmat", ("fit", "expectation", "maximization",
                           "transform"))):
    for name in names:
      timed(obj, prefix, name)
  tr, te = np.flatnonzero(train), np.flatnonzero(~train)
  x_train = stage("fit_transform", lambda: ivec.fit_transform(
      [feats[i] for i in tr]))
  x_test = stage("transform", lambda: ivec.transform([feats[i] for i in te]))
  y_train, y_test = spk[tr], spk[te]
  scorer = stage("scorer_fit", lambda: Scorer(
      method="cosine", wccn=True, device=device).fit(x_train, y_train))
  S = stage("scorer_score", lambda: scorer.score(x_test))
  Pfa, Pmiss, _ = det_curve(
      (y_test[:, None] == scorer.labels[None]).ravel(), S.reshape(-1))
  cos_acc = float(np.mean(scorer.predict(x_test) == y_test))
  plda = stage("plda_fit", lambda: PLDA(**SPK_PLDA, device=device).fit(
      x_train, y_train))
  P = stage("plda_score", lambda: plda.score_matrix(x_test, x_test))
  off = ~np.eye(len(te), dtype=bool)
  Qfa, Qmiss, _ = det_curve((y_test[:, None] == y_test[None])[off],
                            P[torch.from_numpy(off).to(P.device)])
  plda_acc = float(np.mean(plda.predict(x_test) == y_test))
  out["wall_s"] = time.perf_counter() - t0
  out.update(raw=raw, feats=feats, spk=spk, train=train, ivec=ivec,
             x_train=x_train,
             x_test=x_test, scorer=scorer, S=S, plda=plda, P=P,
             cos_eer=compute_EER(Pfa, Pmiss),
             cos_dcf=compute_minDCF(Pfa, Pmiss)[0], cos_acc=cos_acc,
             plda_eer=compute_EER(Qfa, Qmiss), plda_acc=plda_acc,
             n_frames=sum(len(f) for f in feats),
             n_train_frames=sum(len(feats[i]) for i in tr))
  return out


def level_llks(history):
  """The llk per frame of the last E-step of each mixup level."""
  last = {}
  for m, _, llk in history:
    last[m] = llk
  return [last[m] for m in sorted(last)]


def speaker_path(torch, np, reset_counts, read_counts, smi):
  """Phase 11: the README's speaker quickstart on the card (see the
  docstring); returns K1's launches on the path."""
  import glob
  import os
  import shutil
  from odin_tpu_torch.backend import compute_EER, det_curve
  from odin_tpu_torch.ml import GMM, PLDA, Ivector, Scorer, Tmatrix
  from odin_tpu_torch.preprocessing import batch_speech_features

  root = corpus_root()
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
  if len(files) != CORPUS_SPEAKERS * CORPUS_UTTERANCES:
    raise AssertionError(f"{len(files)} wav files of phase 9 left")
  cache = os.path.join(root, "ivector")

  # -- 11.1 the README's lines on the card: the main path
  reset_counts()
  r = speaker_recipe(torch, np, files, "cuda", SPK_NMIX, cache)
  counts = read_counts()
  n_batches = -(-len(files) // CORPUS_BATCH)
  log(f"speaker path launches (batch_speech_features of {len(files)} "
      f"files, {n_batches} batches of {CORPUS_BATCH}; the rest runs cuBLAS, "
      f"cuSOLVER and torch's own kernels): {counts}")
  if counts["logmel"] != n_batches or counts["logmel_fft"] != n_batches:
    raise AssertionError(f"the speaker path launched K1 {counts}, not once "
                         f"a batch ({n_batches})")
  gmm, tmat = r["ivec"].gmm, r["ivec"].tmat
  calls = r["calls"]
  final = [t for t, (m, _, _) in zip(calls["gmm.expectation"],
                                     gmm.llk_history) if m == SPK_NMIX]
  est = sorted(final)[len(final) // 2]
  fit_s = calls["gmm.fit"][0]
  tm_iter = [a + b for a, b in zip(calls["tmat.expectation"],
                                   calls["tmat.maximization"])]
  tb_s = calls["gmm.transform_batch"][0]
  n_train, n_test = int(r["train"].sum()), int((~r["train"]).sum())
  tb_frames = r["n_train_frames"]
  log(f"speaker recipe on the card, {len(files)} files, "
      f"{r['n_frames']} frames of 20 dims ({tb_frames} train): read "
      f"{r['read_s']:.3f} s; features {r['features_s']:.3f} s; GMM fit "
      f"(nmix {SPK_NMIX}) {fit_s:.3f} s, {len(gmm.llk_history)} E-steps, "
      f"{1e3 * est:.3f} ms an E-step at {SPK_NMIX} mixtures (median of "
      f"{len(final)}), {tb_frames / est:.1f} frames/s; transform_batch "
      f"{tb_frames / tb_s:.1f} frames/s ({1e3 * tb_s:.3f} ms for "
      f"{n_train} utterances); T-matrix "
      f"{1e3 * sorted(tm_iter)[len(tm_iter) // 2]:.3f} ms an EM iteration "
      f"(median of {len(tm_iter)}), fit {calls['tmat.fit'][0]:.3f} s; "
      f"i-vectors {n_test / r['transform_s']:.1f} utterances/s "
      f"({r['transform_s']:.3f} s for {n_test}, statistics included; "
      f"tmat.transform {1e3 * calls['tmat.transform'][-1]:.3f} ms); "
      f"Scorer fit {1e3 * r['scorer_fit_s']:.3f} ms, score "
      f"{1e3 * r['scorer_score_s']:.3f} ms; PLDA fit "
      f"{1e3 * r['plda_fit_s']:.3f} ms, score_matrix "
      f"{1e3 * r['plda_score_s']:.3f} ms; the recipe {r['wall_s']:.3f} s, "
      f"features included; {smi}")
  by_level = {}
  for t, (m, _, _) in zip(calls["gmm.expectation"], gmm.llk_history):
    by_level.setdefault(m, []).append(t)
  log("GMM E-step ms by mixtures (median, count): " + ", ".join(
      f"{m}: {1e3 * sorted(v)[len(v) // 2]:.3f} ({len(v)})"
      for m, v in sorted(by_level.items())) + f"; the fit's other work "
      f"{1e3 * (fit_s - sum(calls['gmm.expectation'][:len(gmm.llk_history)])):.3f}"
      f" ms (parking, initialize, M-steps, mixups); {smi}")
  log(f"speaker results on the card: cosine EER {r['cos_eer']:.6f}, "
      f"minDCF {r['cos_dcf']:.6f}, accuracy {r['cos_acc']:.6f} "
      f"({n_test} tests x 64 models); PLDA EER {r['plda_eer']:.6f} "
      f"({n_test * (n_test - 1)} trials), accuracy {r['plda_acc']:.6f}")

  # second calls: the first pays one-time costs (CUDA's lazy loading of
  # each kernel, cuSOLVER's set-up); K1's launches here are not counted
  def again(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t

  ytr = r["spk"][r["train"]]
  second = {
      "features": again(lambda: batch_speech_features(
          r["raw"], features=("mfcc_cmvn",), device="cuda")),
      "Scorer fit": again(lambda: Scorer(method="cosine", wccn=True,
                                         device="cuda").fit(r["x_train"],
                                                            ytr)),
      "Scorer score": again(lambda: r["scorer"].score(r["x_test"])),
      "PLDA fit": again(lambda: PLDA(**SPK_PLDA, device="cuda").fit(
          r["x_train"], ytr)),
      "PLDA score_matrix": again(lambda: r["plda"].score_matrix(
          r["x_test"], r["x_test"])),
      "transform (768 test i-vectors)": again(lambda: r["ivec"].transform(
          [f for f, t in zip(r["feats"], r["train"]) if not t]))}
  log("second calls on the card: " + ", ".join(
      f"{k} {1e3 * v:.3f} ms" for k, v in second.items()) + f"; {smi}")

  # -- 11.2 the recipe learns
  levels = level_llks(gmm.llk_history)
  log("UBM llk per frame at the end of each mixup level: " +
      ", ".join(f"{v:.4f}" for v in levels))
  if not all(b > a for a, b in zip(levels, levels[1:])):
    raise AssertionError("the UBM's llk does not rise over the levels")
  if not (r["cos_eer"] <= SPK_COSINE_EER_MAX and
          r["plda_acc"] >= SPK_PLDA_ACC_MIN):
    raise AssertionError(f"the recipe did not learn: cosine EER "
                         f"{r['cos_eer']} (limit {SPK_COSINE_EER_MAX}), "
                         f"PLDA accuracy {r['plda_acc']} (limit "
                         f"{SPK_PLDA_ACC_MIN})")

  # -- 11.3 the card against the port's CPU path, from the same state
  def apart(got, want):
    got = torch.as_tensor(got).detach().cpu().double()
    want = torch.as_tensor(want).detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())

  def hold(name, value, limit):
    log(f"card against CPU, {name}: {value:.3e} (limit {limit})")
    if not value <= limit:
      raise AssertionError(f"{name}: the card is {value} from the CPU")

  first = r["feats"][:SPK_CPU_FILES]
  X = np.concatenate(first)
  cpu_gmm = GMM.from_state(gmm.state(), device="cpu")
  t0 = time.perf_counter()
  want = cpu_gmm.expectation(X)
  cpu_s = time.perf_counter() - t0
  got = gmm.expectation(X)
  for i, name in enumerate(("Z", "F", "S")):
    hold(f"GMM E-step {name} ({len(X)} frames)", apart(got[i], want[i]),
         SPK_GMM_TOL)
  hold("GMM E-step llk (relative)", abs(got[3] - want[3]) / abs(want[3]),
       SPK_GMM_TOL)
  Zc, Fc = gmm.transform_batch(first)
  Zh, Fh = cpu_gmm.transform_batch(first)
  hold("transform_batch Z", apart(Zc, Zh), SPK_GMM_TOL)
  hold("transform_batch F", apart(Fc, Fh), SPK_GMM_TOL)
  cpu_tmat = Tmatrix(tv_dim=SPK_TV_DIM, gmm=cpu_gmm,
                     device="cpu").load_state(tmat.state())
  got = tmat.expectation(Zc, Fc)
  want = cpu_tmat.expectation(Zc.cpu(), Fc.cpu())
  hold("T-matrix E-step LU", apart(got[0], want[0]), SPK_TMAT_TOL)
  hold("T-matrix E-step RU", apart(got[1], want[1]), SPK_TMAT_TOL)
  hold("T-matrix E-step llk (relative)", abs(got[2] - want[2]) /
       abs(want[2]), SPK_TMAT_TOL)
  # the same Tm on both, so no sign to choose
  hold(f"i-vectors of the first {SPK_CPU_FILES} files",
       apart(tmat.transform((Zc, Fc)), cpu_tmat.transform((Zc.cpu(),
                                                           Fc.cpu()))),
       SPK_TMAT_TOL)
  log(f"the CPU's GMM E-step on those {len(X)} frames: {cpu_s:.3f} s")
  xtr, xte = r["x_train"].cpu(), r["x_test"].cpu()
  ytr, yte = r["spk"][r["train"]], r["spk"][~r["train"]]
  sc = Scorer(method="cosine", wccn=True, device="cpu").fit(xtr, ytr)
  S = sc.score(xte)
  hold("cosine scores (Scorer fitted on the CPU from the card's "
       "i-vectors)", apart(r["S"], S), SPK_SCORE_TOL)
  eer = compute_EER(*det_curve((yte[:, None] == sc.labels[None]).ravel(),
                               S.reshape(-1))[:2])
  pl = PLDA(**SPK_PLDA, device="cpu").fit(xtr, ytr)
  P = pl.score_matrix(xte, xte)
  hold("PLDA llrs (fitted on the CPU from the card's i-vectors)",
       apart(r["P"], P), SPK_SCORE_TOL)
  off = ~np.eye(len(yte), dtype=bool)
  peer = compute_EER(*det_curve((yte[:, None] == yte[None])[off],
                                P.numpy()[off])[:2])
  log(f"EER from the CPU's scores: cosine {eer:.6f}, PLDA {peer:.6f}")
  if eer != r["cos_eer"] or peer != r["plda_eer"]:
    raise AssertionError("the CPU's scores give another EER")

  # -- 11.4 the cache: a second Ivector reloads every stage
  train = [f for f, t in zip(r["feats"], r["train"]) if t]
  t0 = time.perf_counter()
  again = Ivector(path=cache, nmix=SPK_NMIX, tv_dim=SPK_TV_DIM,
                  niter_tmat=SPK_TMAT_ITERS, device="cuda")
  reloaded = again.fit_transform(train)
  test = [f for f, t in zip(r["feats"], r["train"]) if not t]
  same_test = torch.equal(again.transform(test), r["x_test"])
  log(f"cache: a second Ivector(path=...) reloaded {sorted(os.listdir(cache))}"
      f" in {time.perf_counter() - t0:.3f} s (test i-vectors recomputed); "
      f"bitwise equal: train {torch.equal(reloaded, r['x_train'])}, test "
      f"{same_test}")
  if again.gmm.llk_history or not torch.equal(reloaded, r["x_train"]) or \
      not same_test:
    raise AssertionError("the reloaded Ivector differs")

  # -- 11.5 the E-step alone at BASELINE.md:42's shape, from a seed
  g = torch.Generator(torch.device("cuda", 0)).manual_seed(SEED)
  cuda = torch.device("cuda", 0)
  big = GMM(nmix=ESTEP_NMIX, device="cuda")
  big.mu = torch.randn((ESTEP_NMIX, ESTEP_DIM), generator=g, device=cuda)
  big.sigma = 0.5 + torch.rand((ESTEP_NMIX, ESTEP_DIM), generator=g,
                               device=cuda)
  big.w = torch.full((ESTEP_NMIX,), 1.0 / ESTEP_NMIX, device=cuda)
  big.ndim = ESTEP_DIM
  frames = torch.randn((ESTEP_FRAMES, ESTEP_DIM), generator=g, device=cuda)
  big.expectation(frames)  # warm-up
  times = host_times_s(torch, lambda: big.expectation(frames), 5)
  t = times[len(times) // 2]
  # 4 matmuls of 2·M·D a frame (x² @ invᵀ, x @ (mu·inv)ᵀ, postᵀ @ x,
  # postᵀ @ x²) and about 12 operations per frame and mixture beside them
  flops = ESTEP_FRAMES * (8 * ESTEP_NMIX * ESTEP_DIM + 12 * ESTEP_NMIX)
  log(f"GMM E-step {ESTEP_NMIX} mixtures x {ESTEP_DIM} dims over "
      f"{ESTEP_FRAMES} frames on the card (batch_size "
      f"{big.batch_size}): {1e3 * t:.3f} ms (median of {len(times)}, host "
      f"clock, one sync), {ESTEP_FRAMES / t:.1f} frames/s, "
      f"{flops / 1e9:.1f} GFLOP, {flops / t / 1e12:.3f} TFLOP/s = "
      f"{100 * flops / t / FP32_PEAK_FLOPS:.2f} % of fp32 peak; {smi}")
  shutil.rmtree(root, ignore_errors=True)
  return counts["logmel_fft"]


# phase 12: the unsupervised VAE zoo on dSprites
ZOO_BATCH = 64
ZOO_STEPS = 300  # each class's fit: 3 calls of ZOO_K graphed steps
ZOO_K = 100
ZOO_RTOL = 1e-4  # card against CPU: fp32 sums in another order, of each
# ELBO term's largest magnitude over the batch
ZOO_FACTOR_STEPS = 1000  # Kim & Mnih's dSprites setting, cut in length
ZOO_FACTOR_TC = 35.0
ZOO_GYM_ROWS = 2000  # each class's run_model and MIG
ZOO_GYM_SAMPLES = 10000  # FactorVAE's, as phase 10


def zoo_models():
  """(name, factory, batch size, labelled batches) of every class of the
  zoo slice on the full-width dSprites networks (zdim 10), with BetaVAE
  as the yardstick of the steps' cost.  FactorVAE and Factor2VAE take
  twice the batch, split between the ELBO and the discriminator."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.networks import get_networks, vq_dsprites_networks

  def nets(*drop):
    n = get_networks("dsprites", zdim=10)
    for k in drop:
      n.pop(k)
    return n

  b = ZOO_BATCH
  return [
      ("BetaVAE", lambda: vi.BetaVAE(beta=4.0, **nets()), b, False),
      ("Autoencoder", lambda: vi.Autoencoder(**nets()), b, False),
      ("FactorVAE", lambda: vi.FactorVAE(tc_coef=ZOO_FACTOR_TC, **nets()),
       2 * b, False),
      ("Factor2VAE", lambda: vi.Factor2VAE(tc_coef=ZOO_FACTOR_TC,
                                           **nets("latents")), 2 * b, False),
      ("DIPVAE-i", lambda: vi.DIPVAE(only_mean=True, **nets()), b, False),
      ("DIPVAE-ii", lambda: vi.DIPVAE(only_mean=False, **nets()), b, False),
      ("InfoVAE", lambda: vi.InfoVAE(**nets()), b, False),
      ("MIVAE", lambda: vi.MIVAE(**nets()), b, False),
      ("irmVAE", lambda: vi.irmVAE(**nets()), b, False),
      ("irmAE", lambda: vi.irmAE(**nets()), b, False),
      ("HypersphericalVAE", lambda: vi.HypersphericalVAE(**nets()), b, False),
      ("PowersphericalVAE", lambda: vi.PowersphericalVAE(**nets()), b,
       False),
      ("TwoStageVAE", lambda: vi.TwoStageVAE(**nets()), b, False),
      ("VampriorVAE", lambda: vi.VampriorVAE(**nets()), b, False),
      ("VQVAE", lambda: vi.VQVAE(spatial=True, ema=True, restart_dead=True,
                                 **vq_dsprites_networks()), b, False),
      ("StochasticVAE", lambda: vi.StochasticVAE(**nets()), b, False),
      ("ImputeVAE", lambda: vi.ImputeVAE(**nets()), b, False),
      ("DistEncoder", lambda: vi.DistEncoder(
          latents=RVconf(5, "mvndiag", name="targets"), **nets("latents")),
       b, True),
  ]


def zoo_path(torch, np, reset_counts, read_counts, smi):
  """Phase 12: each class of the zoo slice on procedural dSprites: its ELBO
  terms on the card against the CPU, 300 steps of ``fit`` at
  ``steps_per_call=100`` (the held-out loss below its start, no update
  skipped, steps/s), ``run_model`` and MIG on 2,000 test images; then
  FactorVAE at Kim & Mnih's dSprites setting (tc_coef 35, the 5 x 1000
  discriminator) for 1000 steps and the Gym's default report on 10,000
  test images; the vMF sampler's rejected rows and acceptance rate."""
  from odin_tpu_torch.bay.distributions import sampling
  from odin_tpu_torch.bay.vi import DisentanglementGym, FactorVAE
  from odin_tpu_torch.fuel import dSprites, get_dataset
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import Noise

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  t0 = time.perf_counter()
  ds = get_dataset("dsprites")
  ds.numpy("train")
  ds.numpy("test")
  held_x, held_y = dSprites(n_samples=256, seed=1).numpy("valid")
  log(f"get_dataset('dsprites'): train and test rendered in "
      f"{time.perf_counter() - t0:.2f} s; held out: 256 images")

  def to(batch, device):
    return tuple(torch.as_tensor(b).to(device) for b in batch) \
        if isinstance(batch, tuple) else torch.as_tensor(batch).to(device)

  def train(batch_size, labelled):
    return ds.create_dataset("train", batch_size=batch_size, epochs=-1,
                             prefetch=2, label_percent=labelled,
                             to_device=cuda)

  def held(batch_size, labelled):
    x = held_x[:batch_size].astype(np.float32)
    return (x, held_y[:batch_size].astype(np.float32)) if labelled else x

  def term_errors(cpu_terms, card_terms):
    out = {}
    for k, v in cpu_terms.items():
      c = card_terms[k].detach().float().cpu()
      v = v.detach().float()
      out[k] = float((c - v).abs().max()) / max(float(v.abs().max()), 1e-30)
    return out

  # a discarded fit of the first class first, so that no class's rate
  # carries the host pipeline's start-up (its first dataset, thread and
  # pinned buffers) and cuDNN's first choice of algorithms
  name, factory, bs, labelled = zoo_models()[0]
  factory().build(seed=SEED).fit(train(bs, labelled), max_iter=ZOO_K,
                                 steps_per_call=ZOO_K, logging_interval=1e9,
                                 verbose=False)
  sampling.reset_rejection_stats()
  reset_counts()
  rows = []
  step_700 = {d: torch.tensor(700, dtype=torch.int32, device=d)
              for d in (cpu, cuda)}
  for name, factory, bs, labelled in zoo_models():
    # -- 12.1 the card against the CPU: same params, batch and noise
    t_class = time.perf_counter()
    ref = factory().build(seed=SEED, device="cpu")
    vae = factory().build(seed=SEED)
    batch = held(bs, labelled)
    noise = Noise(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
      l0, k0, _ = ref.elbo_components(ref.state.params, to(batch, cpu), noise,
                                      step_700[cpu],
                                      mutables=dict(ref.state.mutables))
      l1, k1, _ = vae.elbo_components(
          vae.state.params, to(batch, cuda),
          Noise(eps=[t.to(cuda) for t in noise.drawn]), step_700[cuda],
          mutables=dict(vae.state.mutables))
    errs = term_errors({**l0, **k0}, {**l1, **k1})
    worst = max(errs.values())
    if not worst <= ZOO_RTOL:
      raise AssertionError(f"{name}: the card's ELBO terms differ from the "
                           f"CPU's: {errs}")
    # -- 12.2 fit: 300 steps, 100 a call
    eval_fn = vae.make_eval_fn()
    hb = to(batch, cuda)
    start = float(eval_fn(vae.state, hb)["loss"])
    tr = vae.fit(train(bs, labelled), max_iter=ZOO_STEPS,
                 steps_per_call=ZOO_K, logging_interval=1e9, verbose=False)
    end = float(eval_fn(vae.state, hb)["loss"])
    skipped = int(vae.state.skipped_updates)
    capture = tr.capture_seconds or 0.0  # None where nothing was captured
    rate = ZOO_STEPS / (tr.total_time - capture)
    if skipped or not end < start:
      raise AssertionError(f"{name}: held-out loss {start:.6g} -> "
                           f"{end:.6g}, {skipped} updates skipped")
    # -- 12.3 the Gym: run_model and MIG (a VQ code map is no vector)
    mig = float("nan")
    if name != "VQVAE":
      gym = DisentanglementGym(dataset=ds, model=vae)
      gym.run_model(n_samples=ZOO_GYM_ROWS, partition="test")
      mig = gym.mig_score()
      if gym.z_mean.device.type != "cuda" or not math.isfinite(mig):
        raise AssertionError(f"{name}: the Gym gave MIG {mig} on "
                             f"{gym.z_mean.device}")
    rows.append((name, bs, worst, start, end, rate, capture, mig,
                 time.perf_counter() - t_class))
    log(f"{name}: ELBO terms card vs CPU max rel {worst:.3e} (limit "
        f"{ZOO_RTOL}); fit {ZOO_STEPS} steps at batch {bs}: held-out loss "
        f"{start:.6g} -> {end:.6g}, skipped {skipped}, {rate:.1f} steps/s "
        f"(capture {capture:.3f} s); MIG on {ZOO_GYM_ROWS} test "
        f"images {mig:.4f}; {time.perf_counter() - t_class:.2f} s")
    del ref, vae, tr
  log(f"zoo steps/s at fit(steps_per_call={ZOO_K}), {ZOO_STEPS} steps each, "
      f"after a discarded warm-up fit ({smi}): " + ", ".join(
          f"{r[0]} {r[5]:.1f}" for r in rows))

  # -- 12.4 FactorVAE at Kim & Mnih's dSprites setting, and the Gym
  t0 = time.perf_counter()
  vae = FactorVAE(tc_coef=ZOO_FACTOR_TC,
                  **get_networks("dsprites", zdim=10)).build(seed=SEED)
  tr = vae.fit(train(2 * ZOO_BATCH, False), max_iter=ZOO_FACTOR_STEPS,
               steps_per_call=ZOO_K, logging_interval=1e9, verbose=False)
  if int(vae.state.skipped_updates):
    raise AssertionError(f"FactorVAE skipped "
                         f"{int(vae.state.skipped_updates)} updates")
  gym = DisentanglementGym(dataset=ds, model=vae)
  gym.run_model(n_samples=ZOO_GYM_SAMPLES, partition="test")
  report = gym.write_report()
  errors = {k: v for k, v in report.items() if k.endswith("_error")}
  bad = [k for k, v in report.items() if not k.endswith("_error") and
         not math.isfinite(float(v))]
  log(f"FactorVAE tc_coef {ZOO_FACTOR_TC}, 5 x 1000 discriminator: "
      f"{ZOO_FACTOR_STEPS} steps at batch {2 * ZOO_BATCH} in "
      f"{tr.total_time:.2f} s; write_report on {ZOO_GYM_SAMPLES} test "
      f"images: " + ", ".join(
          f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
          for k, v in report.items()) +
      f"; {time.perf_counter() - t0:.2f} s")
  if errors or bad:
    raise AssertionError(f"FactorVAE's report failed: {errors} {bad}")
  log("FactorVAE disentanglement scores: " + ", ".join(
      f"{k} {report[k]:.4f}" for k in (
          "mig", "sap", "dci_disentanglement", "dci_completeness",
          "dci_informativeness", "betavae_score", "factorvae_score")))

  # -- 12.5 the vMF sampler over the phase
  stats = sampling.rejection_stats()
  vmf = stats.get("vmf@cuda:0", {})
  log(f"vMF sampler on the card: {vmf.get('rows', 0)} rows, "
      f"{vmf.get('failed', 0)} rejected rows, acceptance rate "
      f"{vmf.get('accepted', 0) / max(vmf.get('proposals', 1), 1):.4f} "
      f"({vmf.get('proposals', 0)} proposals); all samplers: {stats}")
  if not vmf.get("rows") or any(v["failed"] for v in stats.values()):
    raise AssertionError(f"rejection samplers: {stats}")
  log(f"zoo path launches (cuDNN, cuBLAS and torch's kernels, none of "
      f"this port's): {read_counts()}")


# phase 13: the semi-supervised family on dSprites, and M2 on the half-moons
SEMI_BATCH = 64
SEMI_STEPS = 200  # each class's fit: 2 calls of SEMI_K graphed steps
SEMI_K = 100
SEMI_LABELLED = 0.1  # label_percent: 1,638 of the 16,384 train images
SEMI_OVERSAMPLE = 0.5  # the labelled rows of each batch: 32 of 64
# the Semi-Factor pair's supervised term reads the second half of its batch
# (the discriminator's), so 96 of its 128 rows are labelled, 32 of them in
# that half; at 0.5 the half holds no labelled row
SEMI_FACTOR_OVERSAMPLE = 0.75
SEMI_RTOL = ZOO_RTOL  # card against CPU, of each term's largest magnitude
SEMI_HELD = 256  # held-out labelled images for the labels head
SEMI_GYM_ROWS = 2000
MOONS_STEPS = 1000  # the half-moons M2 pair: 10 calls of SEMI_K steps
MOONS_ACC_MIN = 0.95  # classify() accuracy on the 320 test points (the
# CPU rehearsal's: 1.0 for both classes after 1000 steps)
MOONS_RTOL = 1e-5  # marginal_elbo against the explicit sum, on the card


SEMI_POSITIONS = 4  # the categorical classes' labels: pos_x in 4 bins


def position_dsprites(np, **kwargs):
  """dSprites whose labels are the sprite's horizontal position in
  SEMI_POSITIONS bins of 8 of its 32 positions, one-hot (the same images
  as ``dSprites(**kwargs)``)."""
  from odin_tpu_torch.fuel import dSprites

  class dSpritesPosition(dSprites):

    @property
    def name(self):
      return "dspritesposition"

    @property
    def labels(self):
      return [f"pos_x_{i}" for i in range(SEMI_POSITIONS)]

    def _load(self, partition):
      x, f = super()._load(partition)
      bins = (f[:, 3] * SEMI_POSITIONS // self.factor_sizes[3]).astype(int)
      return x, np.eye(SEMI_POSITIONS, dtype=np.float32)[bins]

  return dSpritesPosition(**kwargs)


def semi_models():
  """(name, factory, batch size, labels, labelled share of a batch) of
  every class of the
  semi-supervised slice on the full-width dSprites networks (zdim 10) with
  their labels head.  The Multitask and Semafo families regress dSprites'
  5 factor indices with the networks' Gaussian head ('factors'); the
  classes whose objective reads the labels head as class probabilities
  (the M2 family, ADGM) and the Semi-Factor pair, whose supervised term
  is a softmax cross-entropy, take one-hot labels of the sprite's
  horizontal position ('position', ``position_dsprites``) and a one-hot
  head.  The Semi-Factor pair takes twice the batch, split between the
  ELBO and the discriminator, with SEMI_FACTOR_OVERSAMPLE of it
  labelled."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.networks import get_networks

  def nets(*drop, shape=False):
    n = get_networks("dsprites", zdim=10, is_semi_supervised=True)
    if shape:
      n["labels"] = RVconf(SEMI_POSITIONS, "onehot", projection=True,
                           name="position")
    for k in drop:
      n.pop(k)
    return n

  b, r = SEMI_BATCH, SEMI_OVERSAMPLE
  factor = dict(n_labels=SEMI_POSITIONS, tc_coef=ZOO_FACTOR_TC)
  return [
      ("MultitaskVAE", lambda: vi.MultitaskVAE(**nets()), b, "dsprites", r),
      ("SkiptaskVAE", lambda: vi.SkiptaskVAE(**nets()), b, "dsprites", r),
      ("MultiheadVAE", lambda: vi.MultiheadVAE(**nets()), b, "dsprites", r),
      ("M2VAE", lambda: vi.M2VAE(**nets(shape=True)), b, "position", r),
      ("ConditionalM2VAE", lambda: vi.ConditionalM2VAE(**nets(shape=True)),
       b, "position", r),
      ("StructuredSemiVAE", lambda: vi.StructuredSemiVAE(
          **nets("latents", shape=True)), b, "position", r),
      ("reparamsM3VAE", lambda: vi.reparamsM3VAE(**nets(shape=True)), b,
       "position", r),
      ("auxiliaryVAE", lambda: vi.auxiliaryVAE(**nets(shape=True)), b,
       "position", r),
      ("SemafoVAE", lambda: vi.SemafoVAE(**nets()), b, "dsprites", r),
      ("RemafoVAE", lambda: vi.RemafoVAE(**nets()), b, "dsprites", r),
      ("semafod", lambda: vi.semafod(**nets()), b, "dsprites", r),
      ("semafoh", lambda: vi.semafoh(**nets()), b, "dsprites", r),
      ("semafos", lambda: vi.semafos(**nets()), b, "dsprites", r),
      ("semafosm", lambda: vi.semafosm(**nets()), b, "dsprites", r),
      ("semafosc", lambda: vi.semafosc(**nets()), b, "dsprites", r),
      ("semafop", lambda: vi.semafop(**nets()), b, "dsprites", r),
      ("semafot", lambda: vi.semafot(**nets()), b, "dsprites", r),
      ("SemiFactorVAE", lambda: vi.SemiFactorVAE(**factor, **nets("labels")),
       2 * b, "position", SEMI_FACTOR_OVERSAMPLE),
      ("SemiFactor2VAE", lambda: vi.SemiFactor2VAE(
          **factor, **nets("labels", "latents")), 2 * b, "position",
       SEMI_FACTOR_OVERSAMPLE),
  ]


def semi_batch(np, x, y, n, share=SEMI_OVERSAMPLE):
  """The first n rows of (x, y) as an (x, y, mask) batch whose first
  ``round(share * n)`` rows are labelled and whose other rows' labels are
  zeros, as ``create_dataset(label_percent=...)`` makes them."""
  x, y = x[:n].astype(np.float32), y[:n].astype(np.float32).copy()
  k = int(round(share * n))
  mask = np.zeros(n, np.float32)
  mask[:k] = 1
  y[k:] = 0
  return x, y, mask


def semi_path(torch, np, reset_counts, read_counts, smi):
  """Phase 13: each of the 19 classes of the semi-supervised slice on
  procedural dSprites (``semi_models``), trained on (x, y, mask) batches of
  ``create_dataset(label_percent=0.1, oversample_ratio=0.5)``: its ELBO
  terms on the card against the CPU on the same params, batch and noise;
  200 steps of ``fit`` at ``steps_per_call=100`` (the held-out loss below
  its start, no update skipped, steps/s); the labels head's log-likelihood of 256
  held-out labelled images above its value before training; ``run_model``
  and MIG on 2,000 test images.  Then M2VAE and ConditionalM2VAE on the
  half-moons with the one-hot head: ``classify`` accuracy on the test
  split, and ConditionalM2's ``marginal_elbo`` on the card equal to the
  explicit sum over the two one-hot labels."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.vi import DisentanglementGym
  from odin_tpu_torch.fuel import HalfMoons, dSprites, get_dataset
  from odin_tpu_torch.networks import halfmoons_networks
  from odin_tpu_torch.training import Noise

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  t0 = time.perf_counter()
  data = {"dsprites": get_dataset("dsprites"),
          "position": position_dsprites(np)}
  held = {"dsprites": dSprites(n_samples=SEMI_HELD, seed=1).numpy("valid"),
          "position": position_dsprites(np, n_samples=SEMI_HELD,
                                        seed=1).numpy("valid")}
  for ds in data.values():
    ds.numpy("train")
  data["dsprites"].numpy("test")
  log(f"dSprites (factor labels and position labels) train and test "
      f"rendered in "
      f"{time.perf_counter() - t0:.2f} s; held out: {SEMI_HELD} labelled "
      f"images of each")

  def to(batch, device):
    return tuple(torch.as_tensor(b).to(device) for b in batch)

  def train(ds, batch_size, share=SEMI_OVERSAMPLE):
    return ds.create_dataset("train", batch_size=batch_size, epochs=-1,
                             prefetch=2, label_percent=SEMI_LABELLED,
                             oversample_ratio=share, to_device=cuda)

  def term_errors(cpu_terms, card_terms):
    out = {}
    for k, v in cpu_terms.items():
      c = card_terms[k].detach().float().cpu()
      v = v.detach().float()
      out[k] = float((c - v).abs().max()) / max(float(v.abs().max()), 1e-30)
    return out

  @torch.no_grad()
  def labels_llk(vae, x, y):
    return float(vae.predict_labels(x).log_prob(
        torch.as_tensor(y).to(cuda)).mean())

  reset_counts()
  rows = []
  step_700 = {d: torch.tensor(700, dtype=torch.int32, device=d)
              for d in (cpu, cuda)}
  for name, factory, bs, dname, share in semi_models():
    # -- 13.1 the card against the CPU: same params, batch and noise
    t_class = time.perf_counter()
    hx, hy = held[dname]
    batch = semi_batch(np, hx, hy, bs, share)
    ref = factory().build(seed=SEED, device="cpu")
    vae = factory().build(seed=SEED)
    noise = Noise(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
      l0, k0, _ = ref.elbo_components(ref.state.params, to(batch, cpu), noise,
                                      step_700[cpu],
                                      mutables=dict(ref.state.mutables))
      l1, k1, _ = vae.elbo_components(
          vae.state.params, to(batch, cuda),
          Noise(eps=[t.to(cuda) for t in noise.drawn]), step_700[cuda],
          mutables=dict(vae.state.mutables))
    errs = term_errors({**l0, **k0}, {**l1, **k1})
    worst = max(errs.values())
    if not worst <= SEMI_RTOL:
      raise AssertionError(f"{name}: the card's ELBO terms differ from the "
                           f"CPU's: {errs}")
    del ref
    # -- 13.2 fit: 200 steps, 100 a call, on (x, y, mask) batches
    eval_fn = vae.make_eval_fn()
    hb = to(batch, cuda)
    start = float(eval_fn(vae.state, hb)["loss"])
    llk0 = labels_llk(vae, hx, hy)
    tr = vae.fit(train(data[dname], bs, share), max_iter=SEMI_STEPS,
                 steps_per_call=SEMI_K, logging_interval=1e9, verbose=False)
    end = float(eval_fn(vae.state, hb)["loss"])
    llk1 = labels_llk(vae, hx, hy)
    skipped = int(vae.state.skipped_updates)
    capture = tr.capture_seconds or 0.0
    rate = SEMI_STEPS / (tr.total_time - capture)
    if skipped or not end < start or not llk1 > llk0:
      raise AssertionError(
          f"{name}: held-out loss {start:.6g} -> {end:.6g}, labels head's "
          f"log-likelihood {llk0:.6g} -> {llk1:.6g}, {skipped} updates "
          f"skipped")
    # -- 13.3 the Gym: run_model and MIG on dSprites' test images
    gym = DisentanglementGym(dataset=data["dsprites"], model=vae)
    gym.run_model(n_samples=SEMI_GYM_ROWS, partition="test")
    mig = gym.mig_score()
    if gym.z_mean.device.type != "cuda" or not math.isfinite(mig):
      raise AssertionError(f"{name}: the Gym gave MIG {mig} on "
                           f"{gym.z_mean.device}")
    rows.append((name, rate))
    log(f"{name} on {dname}: ELBO terms card vs CPU max rel {worst:.3e} "
        f"(limit {SEMI_RTOL}); fit {SEMI_STEPS} steps at batch {bs} "
        f"({int(round(share * bs))} labelled): held-out loss "
        f"{start:.6g} -> {end:.6g}, skipped {skipped}, labels head's "
        f"log-likelihood of {SEMI_HELD} held-out images {llk0:.6g} -> "
        f"{llk1:.6g}, {rate:.1f} steps/s (capture {capture:.3f} s); MIG on "
        f"{SEMI_GYM_ROWS} test images {mig:.4f}; "
        f"{time.perf_counter() - t_class:.2f} s")
    del vae, tr, gym
  log(f"semi-supervised steps/s at fit(steps_per_call={SEMI_K}), "
      f"{SEMI_STEPS} steps each ({smi}): " +
      ", ".join(f"{n} {r:.1f}" for n, r in rows))

  # -- 13.4 M2 and ConditionalM2 on the half-moons, the one-hot head
  moons = HalfMoons()
  x_test, y_test = moons.numpy("test")
  for name in ("M2VAE", "ConditionalM2VAE"):
    t1 = time.perf_counter()
    vae = getattr(vi, name)(**halfmoons_networks(
        is_semi_supervised=True)).build(seed=SEED)
    tr = vae.fit(train(moons, SEMI_BATCH), max_iter=MOONS_STEPS,
                 steps_per_call=SEMI_K, logging_interval=1e9, verbose=False)
    with torch.no_grad():
      pred = vae.classify(x_test).mean().argmax(-1).cpu().numpy()
    acc = float(np.mean(pred == y_test))
    skipped = int(vae.state.skipped_updates)
    msg = (f"{name} on the half-moons: {MOONS_STEPS} steps at batch "
           f"{SEMI_BATCH} in {tr.total_time:.2f} s, skipped {skipped}; "
           f"classify accuracy on {len(y_test)} test points {acc:.4f} "
           f"(limit {MOONS_ACC_MIN})")
    if skipped or not acc >= MOONS_ACC_MIN:
      raise AssertionError(msg)
    if name == "ConditionalM2VAE":
      xs, ys = moons.numpy("valid")
      b = semi_batch(np, xs, np.eye(2, dtype=np.float32)[ys], SEMI_BATCH)
      xb, yb, mb = to(b, cuda)
      params = vae.state.params
      noise = Noise(torch.Generator(cuda).manual_seed(SEED))
      with torch.no_grad():
        llk, kl, aux = vae.elbo_components(params, (xb, yb, mb), noise,
                                           vae.state.step)
        eps = noise.drawn[0]  # (B·K, zdim): row b·K + k is (b, label k)
        w = mb[:, None] * yb + (1 - mb[:, None]) * aux["qy"].mean()
        explicit = torch.zeros_like(llk["marginal_elbo"])
        for k in range(2):
          onehot = torch.zeros_like(yb)
          onehot[:, k] = 1
          lx, kz, *_ = vae._components_xy(params, xb, onehot,
                                          Noise(eps=[eps[k::2]]), False,
                                          None)
          explicit = explicit + w[:, k] * (lx - kz)
      err = float((llk["marginal_elbo"] - explicit).abs().max()) / max(
          float(explicit.abs().max()), 1e-30)
      msg += (f"; marginal_elbo against the explicit sum over the 2 one-hot "
              f"labels on the card: max rel {err:.3e} (limit {MOONS_RTOL})")
      if not err <= MOONS_RTOL:
        raise AssertionError(msg)
    log(msg + f"; {time.perf_counter() - t1:.2f} s; {smi}")
    del vae, tr
  log(f"semi path launches (cuDNN, cuBLAS and torch's kernels, none of "
      f"this port's): {read_counts()}")


# phase 14: the hierarchical and grouped families on dSprites
HIER_BATCH = 64  # images, or pairs for the grouped family
HIER_STEPS = 200  # each class's fit: 2 calls of HIER_K graphed steps
HIER_K = 100
HIER_RTOL = ZOO_RTOL  # card against CPU, of each term's largest magnitude
HIER_GYM_ROWS = 2000  # run_model and MIG (unpaired for the grouped family)
HIER_PAIRS = 2048  # pairs rendered for each pairing protocol
HIER_TIE = 1e-4  # a shared-dimension decision within this share of the
# row's largest symmetric KL of its threshold is a tie
HIER_KL_RTOL = 1e-6  # the Gym's KL against the model's own KL terms


def hier_models():
  """(name, factory, pairing protocol or None, the training step's
  options) of every class of the slice on the full-width dSprites
  networks (zdim 10) with JAX's ``hierarchy`` spec, at JAX's defaults,
  BetaVAE first as the yardstick: the ladder with each rung kind, the
  U-Nets, VeryDeepVAE, and the grouped family on pairs ('rnd': k of the
  five factors changed, k uniform in 1-4; 'match': one changed; 'rank':
  the x position changed, y = x1's is larger; 'restricted': shape and
  scale shared and given as y, scaled to [0, 1]).  PUnetVAE and the
  BiDense ladder train with ``global_clipnorm=10``: without it their
  Dense ladder heads on the flattened 16 x 16 states spike the gradient
  (a KL against a prior whose scale the decoder learns); PUnetVAE's
  latents' scale hits its floor and its loss diverges within 200 steps,
  in JAX too (PERF.md §6)."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.networks import get_networks

  def nets(latents=None):
    n = get_networks("dsprites", zdim=10)
    if latents is not None:
      n["hierarchy"] = tuple(dict(h, latents=latents)
                             for h in n["hierarchy"])
    return n

  return [
      ("BetaVAE", lambda: vi.BetaVAE(beta=4.0, **nets()), None, {}),
      ("HierarchicalVAE", lambda: vi.HierarchicalVAE(**nets()), None, {}),
      ("HierarchicalVAE-parallel",
       lambda: vi.HierarchicalVAE(**nets("parallel")), None, {}),
      ("HierarchicalVAE-bidense",
       lambda: vi.HierarchicalVAE(**nets("bidense")), None,
       dict(global_clipnorm=10.0)),
      ("UnetVAE", lambda: vi.UnetVAE(**nets()), None, {}),
      ("PUnetVAE", lambda: vi.PUnetVAE(**nets()), None,
       dict(global_clipnorm=10.0)),
      ("VeryDeepVAE", lambda: vi.VeryDeepVAE(**nets()), None, {}),
      ("GroupVAE", lambda: vi.GroupVAE(**nets()), "rnd", {}),
      ("MultiLevelVAE", lambda: vi.MultiLevelVAE(**nets()), "rnd", {}),
      ("AdaptiveVAE-group",
       lambda: vi.AdaptiveVAE(base_method="group", **nets()), "rnd", {}),
      ("AdaptiveVAE-multilevel",
       lambda: vi.AdaptiveVAE(base_method="multilevel", **nets()), "rnd", {}),
      ("WeaklySupervisedVAE-match",
       lambda: vi.WeaklySupervisedVAE(strategy="match", **nets()), "match", {}),
      ("WeaklySupervisedVAE-rank",
       lambda: vi.WeaklySupervisedVAE(strategy="rank", **nets()), "rank", {}),
      ("WeaklySupervisedVAE-restricted",
       lambda: vi.WeaklySupervisedVAE(strategy="restricted", **nets()),
       "restricted", {}),
  ]


def dsprites_pairs(np, protocol, n, seed):
  """`n` pairs of dSprites images rendered by the port's ``dSprites.render``
  from factor rows (the pairs of JAX's tests/test_vae_zoo.py:141-228,
  which the JAX package has no sampler for): (x1, x2, y or None), float32
  arrays, by the protocol of ``hier_models``."""
  from odin_tpu_torch.fuel import dSprites
  ds = dSprites(n_samples=1)
  sizes = np.asarray(ds.factor_sizes)
  rs = np.random.RandomState(seed)
  f1 = ds._sample_factors(n, rs)
  f2 = f1.copy()
  for i in range(n):
    if protocol == "rank":
      changed = [3]
    elif protocol == "match":
      changed = rs.choice(5, 1, replace=False)
    elif protocol == "restricted":
      changed = rs.choice([2, 3, 4], rs.randint(1, 4), replace=False)
    else:  # Locatello et al. 2020's k = Rnd
      changed = rs.choice(5, rs.randint(1, 5), replace=False)
    for j in changed:  # a value other than x1's
      f2[i, j] = (f1[i, j] + rs.randint(1, sizes[j])) % sizes[j]
  y = None
  if protocol == "rank":
    y = (f1[:, 3] > f2[:, 3]).astype(np.float32)
  elif protocol == "restricted":
    y = np.stack([f1[:, 0] / (sizes[0] - 1), f1[:, 1] / (sizes[1] - 1)],
                 -1).astype(np.float32)
  return ds.render(f1), ds.render(f2), y


def hier_path(torch, np, reset_counts, read_counts, smi):
  """Phase 14: each class of the hierarchical and grouped slice
  (``hier_models``) on procedural dSprites: its ELBO terms (each rung's
  ``kl_ladder{i}``, ``pair_loss``) on the card against the CPU on the same
  params, batch and noise, for the grouped family also the mean count of
  shared dimensions (a row that a tie decides is reported, not failed);
  200 steps of ``fit`` at ``steps_per_call=100`` (the held-out loss below
  its start, no update skipped, steps/s; a graphed step's kernels and
  device time beside BetaVAE's); ``run_model`` and MIG on 2,000 test
  images (unpaired for the grouped family: its fallback ELBO); for the
  hierarchical models the Gym's KL of a batch equal to the sum of the
  model's own KL terms and ``sample_observation`` finite; and
  UnetVAE(skip_sample_dropout=1.0)'s training decode equal to its
  generation decode."""
  from torch.profiler import ProfilerActivity, profile

  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.vi import DisentanglementGym
  from odin_tpu_torch.fuel import dSprites, get_dataset
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import Noise, scan_steps

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  t0 = time.perf_counter()
  ds = get_dataset("dsprites")
  ds.numpy("train")
  ds.numpy("test")
  held_x, _ = dSprites(n_samples=HIER_BATCH, seed=1).numpy("valid")
  pools, held_pairs = {}, {}
  for protocol in ("rnd", "match", "rank", "restricted"):
    pools[protocol] = tuple(
        None if a is None else torch.from_numpy(a).to(cuda)
        for a in dsprites_pairs(np, protocol, HIER_PAIRS, SEED))
    held_pairs[protocol] = dsprites_pairs(np, protocol, HIER_BATCH,
                                          SEED + 1)
  log(f"get_dataset('dsprites') train and test, and {HIER_PAIRS} pairs of "
      f"each protocol on the card, rendered in "
      f"{time.perf_counter() - t0:.2f} s")

  def to(batch, device):
    return tuple(torch.as_tensor(b).to(device) for b in batch
                 if b is not None) if isinstance(batch, tuple) \
        else torch.as_tensor(batch).to(device)

  def pair_batches(protocol):
    x1, x2, y = pools[protocol]
    gen = torch.Generator(cuda).manual_seed(SEED)
    while True:
      i = torch.randint(0, HIER_PAIRS, (HIER_BATCH,), generator=gen,
                        device=cuda)
      yield (x1[i], x2[i]) if y is None else (x1[i], x2[i], y[i])

  def train(protocol):
    if protocol is None:
      return ds.create_dataset("train", batch_size=HIER_BATCH, epochs=-1,
                               prefetch=2, to_device=cuda)
    return pair_batches(protocol)

  def term_errors(cpu_terms, card_terms):
    out = {}
    for k, v in cpu_terms.items():
      c = card_terms[k].detach().float().cpu()
      v = v.detach().float()
      out[k] = float((c - v).abs().max()) / max(float(v.abs().max()), 1e-30)
    return out

  def graphed_step(vae, batch, options, k=10):
    """(kernels, device ms) a step of a CUDA graph of `k` steps on the
    held-out batch, after one unprofiled call: the step's cost without
    the host pipeline, as ``--zoo-profile`` reads it."""
    fused = scan_steps(vae.make_step_fn(**options), k)
    stacked = tuple(torch.stack([b] * k) for b in batch) \
        if isinstance(batch, tuple) else torch.stack([batch] * k)
    state, _ = fused(vae.state, stacked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      state, _ = fused(state, stacked)
      torch.cuda.synchronize()
    busy_ms, n = device_busy(torch, prof)
    return n / k, busy_ms / k

  reset_counts()
  step_700 = {d: torch.tensor(700, dtype=torch.int32, device=d)
              for d in (cpu, cuda)}
  # a discarded fit first, so that no class's rate carries the host
  # pipeline's start-up and cuDNN's first choice of algorithms
  _, factory, _, _ = hier_models()[0]
  factory().build(seed=SEED).fit(train(None), max_iter=HIER_K,
                                 steps_per_call=HIER_K, logging_interval=1e9,
                                 verbose=False)
  rows, base_ms = [], None
  for name, factory, protocol, options in hier_models():
    t_class = time.perf_counter()
    ref = factory().build(seed=SEED, device="cpu")
    vae = factory().build(seed=SEED)
    batch = held_x if protocol is None else held_pairs[protocol]
    # -- 14.1 the card against the CPU: same params, batch and noise
    noise = Noise(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
      l0, k0, a0 = ref.elbo_components(ref.state.params, to(batch, cpu),
                                       noise, step_700[cpu])
      l1, k1, a1 = vae.elbo_components(
          vae.state.params, to(batch, cuda),
          Noise(eps=[t.to(cuda) for t in noise.drawn]), step_700[cuda])
    errs = term_errors({**l0, **k0}, {**l1, **k1})
    worst = max(errs.values())
    if not worst <= HIER_RTOL:
      raise AssertionError(f"{name}: the card's ELBO terms differ from the "
                           f"CPU's: {errs}")
    shared = ""
    if protocol is not None:
      n_cpu, n_card = float(a0["n_shared"]), float(a1["n_shared"])
      flips = shared_flips(torch, ref, vae, to(batch, cpu), to(batch, cuda))
      shared = (f"; mean shared dims card {n_card:.6g} CPU {n_cpu:.6g}, "
                f"rows flipped {flips['flipped']}, of them decided by a tie "
                f"{flips['ties']} (rows near a tie: {flips['near_ties']})")
      untied = [r for r in flips["flipped"] if r not in flips["ties"]]
      if untied or (n_cpu != n_card and not flips["flipped"]):
        raise AssertionError(f"{name}: the card's shared dimensions differ "
                             f"from the CPU's{shared}")
    del ref
    # -- 14.2 a graphed step's kernels and device time; fit: 200 steps,
    # 100 a call
    kernels, step_ms = graphed_step(vae, to(batch, cuda), options)
    base_ms = base_ms or step_ms
    eval_fn = vae.make_eval_fn()
    hb = to(batch, cuda)
    start = float(eval_fn(vae.state, hb)["loss"])
    tr = vae.fit(train(protocol), max_iter=HIER_STEPS, steps_per_call=HIER_K,
                 logging_interval=1e9, verbose=False, **options)
    end = float(eval_fn(vae.state, hb)["loss"])
    skipped = int(vae.state.skipped_updates)
    capture = tr.capture_seconds or 0.0
    rate = HIER_STEPS / (tr.total_time - capture)
    if skipped or not end < start:
      raise AssertionError(f"{name}: held-out loss {start:.6g} -> "
                           f"{end:.6g}, {skipped} updates skipped")
    # -- 14.3 the Gym: run_model and MIG; the Gym's KL is the model's own
    gym = DisentanglementGym(dataset=ds, model=vae)
    gym.run_model(n_samples=HIER_GYM_ROWS, partition="test")
    mig = gym.mig_score()
    if gym.z_mean.device.type != "cuda" or not math.isfinite(mig):
      raise AssertionError(f"{name}: the Gym gave MIG {mig} on "
                           f"{gym.z_mean.device}")
    extra = ""
    if protocol is None:
      xb = torch.as_tensor(gym.x_true[:gym.batch_size]).to(cuda)
      with torch.no_grad():
        _, kl, _ = vae.elbo_components(
            vae.state.params, xb,
            Noise(torch.Generator(cuda).manual_seed(gym.seed)),
            vae.state.step)
        total = sum(v.float() for v in kl.values())
        px = vae.sample_observation(16, seed=SEED)
      gym_kl = gym.kl_divergence_values()[:gym.batch_size]
      kl_err = float((gym_kl - total).abs().max()) / max(
          float(total.abs().max()), 1e-30)
      finite = bool(torch.isfinite(px.mean()).all())
      extra = (f"; the Gym's KL against the sum of {sorted(kl)} max rel "
               f"{kl_err:.3e} (limit {HIER_KL_RTOL}); sample_observation "
               f"finite: {finite}")
      if not kl_err <= HIER_KL_RTOL or not finite:
        raise AssertionError(f"{name}{extra}")
    ratio = step_ms / base_ms if base_ms else float("nan")  # no card: 0 ms
    rows.append((name, rate, ratio, kernels))
    log(f"{name}: ELBO terms card vs CPU max rel {worst:.3e} over "
        f"{sorted(errs)} (limit {HIER_RTOL}){shared}; a graphed step "
        f"{kernels:.0f} kernels and {step_ms:.3f} ms of device time "
        f"({ratio:.2f}x BetaVAE's); fit {HIER_STEPS} steps at "
        f"batch {HIER_BATCH}: held-out loss {start:.6g} -> {end:.6g}, "
        f"skipped {skipped}, {rate:.1f} steps/s (capture {capture:.3f} s); "
        f"MIG on "
        f"{HIER_GYM_ROWS} test images {mig:.4f}{extra}; "
        f"{time.perf_counter() - t_class:.2f} s")
    del vae, tr, gym

  # -- 14.4 UnetVAE(skip_sample_dropout=1.0): the gated training decode is
  # the generation decode
  unet = vi.UnetVAE(skip_sample_dropout=1.0,
                    **get_networks("dsprites", zdim=10)).build(seed=SEED)
  params = unet.state.params
  torch.backends.cudnn.deterministic = True  # bitwise: one algorithm each
  try:
    with torch.no_grad():
      qz, hiddens = unet._core(params, "encode", to(held_x, cuda),
                               noise=unet._noise(SEED))
      gated, _ = unet._core(params, "decode", qz.mean(), hiddens,
                            training=True, noise=unet._noise(SEED))
      no_skip, _ = unet._core(params, "decode", qz.mean(), None,
                              training=True, noise=unet._noise(SEED))
  finally:
    torch.backends.cudnn.deterministic = False
  same = bool(torch.equal(gated.mean(), no_skip.mean()))
  log(f"UnetVAE(skip_sample_dropout=1.0) on the card: training decode "
      f"equal to the generation decode, bitwise with cuDNN's deterministic "
      f"algorithms: {same}")
  if not same:
    raise AssertionError("UnetVAE's gated decode differs from the "
                         "generation decode")
  log(f"hier steps/s at fit(steps_per_call={HIER_K}), {HIER_STEPS} steps "
      f"each, after a discarded warm-up fit ({smi}): " + ", ".join(
          f"{n} {r:.1f}" for n, r, _, _ in rows) +
      "; a graphed step against BetaVAE's (device time), kernels: " +
      ", ".join(f"{n} {x:.2f}x {k:.0f}" for n, _, x, k in rows))
  log(f"hier path launches (cuDNN, cuBLAS and torch's kernels, none of "
      f"this port's): {read_counts()}")


def shared_flips(torch, ref, vae, cpu_batch, card_batch):
  """The rows of a pair batch whose shared-dimension mask differs between
  the card and the CPU, and those of them that a tie decides: an
  adaptive row's symmetric KL within ``HIER_TIE`` of its threshold, a
  'match' row's k-th and (k+1)-th smallest within it of each other (as
  shares of the row's largest)."""
  from odin_tpu_torch.bay.vi.autoencoder.self_supervised_vae import (
      _sym_kl_per_dim)
  masks, deltas = [], None
  for model, batch in ((ref, cpu_batch), (vae, card_batch)):
    x1, x2 = batch[0], batch[1]
    with torch.no_grad():
      qz = model.encode(torch.cat([x1, x2], 0))
    m, s = qz.mean(), qz.stddev()
    B = x1.shape[0]
    masks.append(model._shared_mask(m[:B], s[:B], m[B:], s[B:]).cpu())
    if deltas is None:
      deltas = _sym_kl_per_dim(m[:B], s[:B], m[B:], s[B:])
  flipped = (masks[0] != masks[1]).any(-1).nonzero().flatten().tolist()
  scale = deltas.abs().amax(-1).clamp(min=1e-30)
  if getattr(ref, "strategy", None) == "match":
    k = max(deltas.shape[-1] - ref.n_changed, 0)
    srt = deltas.sort(-1).values
    gap = (srt[:, k] - srt[:, k - 1]).abs() if 0 < k < srt.shape[-1] \
        else torch.full_like(scale, float("inf"))
  else:
    tau = 0.5 * (deltas.amax(-1, keepdim=True) + deltas.amin(-1,
                                                             keepdim=True))
    gap = (deltas - tau).abs().amin(-1)
  ties = (gap <= HIER_TIE * scale).nonzero().flatten().tolist()
  return {"flipped": flipped, "ties": [r for r in flipped if r in ties],
          "near_ties": ties}


def semi_rehearsal(argv) -> int:
  """``python3 chip_smoke.py --semi-rehearsal [--steps 40] [--k 20]
  [--gym-rows 200] [--moons-steps 200] [--n-samples 2048]
  [--labels position|shape] [--steps-without-mi N] [--factor-oversample R]
  [CLASS ...]``: phase 13 (``semi_path``) on the
  CPU at a chosen size, to rehearse it before a card run and to set its
  limits.  The phase's code runs with the card swapped for the CPU:
  dSprites has `--n-samples` images a partition (16,384 on the card), each
  class trains `--steps` steps at `--k` a call, the Gym reads
  `--gym-rows` test images and the half-moons pair trains
  `--moons-steps` steps; ``--labels shape`` gives the categorical classes
  dSprites0's one-hot shapes (3 classes) in place of the x position in 4
  bins; ``--steps-without-mi`` moves the Semafo family's MI gate and
  ``--factor-oversample`` the Semi-Factor pair's labelled share.  The
  phase's checks run as they are (``rehearse_on_cpu``)."""
  import argparse

  from odin_tpu_torch.fuel import dSprites0

  ap = argparse.ArgumentParser(prog="chip_smoke.py --semi-rehearsal")
  ap.add_argument("--steps", type=int, default=40)
  ap.add_argument("--k", type=int, default=20)
  ap.add_argument("--gym-rows", type=int, default=200)
  ap.add_argument("--moons-steps", type=int, default=200)
  ap.add_argument("--n-samples", type=int, default=2048)
  ap.add_argument("--labels", choices=("position", "shape"),
                  default="position")
  ap.add_argument("--steps-without-mi", type=int, default=None)
  ap.add_argument("--factor-oversample", type=float,
                  default=SEMI_FACTOR_OVERSAMPLE)
  ap.add_argument("classes", nargs="*")
  args = ap.parse_args(argv)
  scope = dict(SEMI_STEPS=args.steps, SEMI_K=args.k,
               SEMI_GYM_ROWS=args.gym_rows, MOONS_STEPS=args.moons_steps)
  for env in (scope, globals()):
    env["SEMI_FACTOR_OVERSAMPLE"] = args.factor_oversample
    if args.labels == "shape":
      env["SEMI_POSITIONS"] = 3
      env["position_dsprites"] = lambda np, **kwargs: dSprites0(**kwargs)

  def gated(factory):
    def make():
      vae = factory()
      if hasattr(vae, "steps_without_mi"):  # read at every step
        vae.steps_without_mi = args.steps_without_mi
      return vae
    return make

  models = [(n, f if args.steps_without_mi is None else gated(f), b, d, r)
            for n, f, b, d, r in semi_models()
            if not args.classes or n in args.classes]
  scope["semi_models"] = lambda: models
  return rehearse_on_cpu(semi_path, args.n_samples, scope, 13)


def device_busy(torch, prof):
  """(ms the device was busy: the union of the kernels' intervals, the
  number of kernels) of a ``torch.profiler`` run."""
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  total, end = 0, None
  for a, b in spans:
    if end is None or a > end:
      total += b - a
      end = b
    elif b > end:
      total += b - end
      end = b
  return total / 1e3, len(spans)


def hier_rehearsal(argv) -> int:
  """``python3 chip_smoke.py --hier-rehearsal [--steps 20] [--k 10]
  [--gym-rows 128] [--n-samples 512] [--pairs 256] [CLASS ...]``: phase 14
  (``hier_path``) on the CPU at a chosen size, to rehearse it before a
  card run (``rehearse_on_cpu``): dSprites has `--n-samples` images a
  partition (16,384 on the card), `--pairs` pairs a protocol (2,048),
  each class trains `--steps` steps at `--k` a call and the Gym reads
  `--gym-rows` test images; the graphed step's kernels and device time
  read 0 (no card)."""
  import argparse

  ap = argparse.ArgumentParser(prog="chip_smoke.py --hier-rehearsal")
  ap.add_argument("--steps", type=int, default=20)
  ap.add_argument("--k", type=int, default=10)
  ap.add_argument("--gym-rows", type=int, default=128)
  ap.add_argument("--n-samples", type=int, default=512)
  ap.add_argument("--pairs", type=int, default=256)
  ap.add_argument("classes", nargs="*")
  args = ap.parse_args(argv)
  models = [m for m in hier_models()
            if not args.classes or m[0] in args.classes or
            m[0] == "BetaVAE"]
  return rehearse_on_cpu(hier_path, args.n_samples, dict(
      HIER_STEPS=args.steps, HIER_K=args.k, HIER_GYM_ROWS=args.gym_rows,
      HIER_PAIRS=args.pairs, hier_models=lambda: models), 14)


def rehearse_on_cpu(path, n_images, scope_updates, phase):
  """Run the phase function `path` of this script on the CPU: its source
  recompiled with the card swapped for the CPU, every dSprites cut to
  `n_images` images a partition, and `scope_updates` (names of this
  module) in its scope; the phase's checks run as they are."""
  import inspect

  import numpy as np
  import torch

  from odin_tpu_torch.fuel.image_data import datasets

  init = datasets.dSprites.__init__

  def sized(self, n_samples=None, **kwargs):
    init(self, n_samples=n_samples or n_images, **kwargs)

  datasets.dSprites.__init__ = sized
  torch.cuda.synchronize = lambda *a, **k: None
  src = inspect.getsource(path)
  src = src.replace('torch.device("cuda", 0)', 'torch.device("cpu")')
  src = src.replace(".build(seed=SEED)", '.build(seed=SEED, device="cpu")')
  src = src.replace('device.type != "cuda"', 'device.type != "cpu"')
  scope = dict(globals())
  scope.update(scope_updates)
  exec(src, scope)
  t0 = time.perf_counter()
  scope[path.__name__](torch, np, lambda: None, lambda: {},
                       "CPU rehearsal, no card")
  log(f"phase {phase} rehearsed on the CPU in "
      f"{time.perf_counter() - t0:.2f} s")
  return 0


def zoo_profile(wanted) -> int:
  """``python3 chip_smoke.py --zoo-profile [CLASS ...]``: where the zoo's
  training steps spend the card's time, without the rest of the script.
  Each class of ``zoo_models()``, ``semi_models()`` and ``hier_models()``
  (all, or BetaVAE and the ones named; the semi-supervised ones on (x, y,
  mask) batches, the grouped ones on pairs of batch 64) as a
  CUDA graph of its whole step, fed from batches already on the card, so
  that no host pipeline stands in the way: random binary images from a
  seed (the ops and their shapes do not depend on the values), fp32 with
  TF32 off.  Prints, with the card's name and power limit, for each
  class: ms a step of ``scan_steps(step, 50)`` (host clock around 3
  synchronised calls after a warm-up, median), its ratio to BetaVAE's,
  and under ``torch.profiler`` for one call of 10 graphed steps the
  kernels a step, the device's busy time a step (the union of the
  kernels' intervals) and the three kernels that take the most time."""
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile

  from odin_tpu_torch.training import scan_steps

  if not torch.cuda.is_available():
    print("chip_smoke --zoo-profile: no CUDA card visible", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip()
  cuda = torch.device("cuda", 0)
  rs = np.random.RandomState(SEED)

  def batches_of(labels):
    """k steps' batches of bs images: x alone, (x, the 5 factors) for a
    labelled class, (x, y, mask) for a semi-supervised one (y dSprites'
    factors or one-hot positions, the first half labelled), (x1, x2[, y])
    pairs for a grouped one (y a 0/1 rank or two factor values)."""
    def make(k, bs):
      x = torch.from_numpy((rs.rand(k, bs, 64, 64, 1) < 0.3).astype(
          np.float32)).to(cuda)
      if not labels:
        return x
      if str(labels).startswith("pair"):
        x2 = torch.from_numpy((rs.rand(k, bs, 64, 64, 1) < 0.3).astype(
            np.float32)).to(cuda)
        y = {"pair-rank": lambda: (rs.rand(k, bs) < 0.5),
             "pair-restricted": lambda: rs.rand(k, bs, 2)}.get(labels)
        return (x, x2) if y is None else \
            (x, x2, torch.from_numpy(y().astype(np.float32)).to(cuda))
      if labels is True:
        return x, torch.from_numpy(rs.rand(k, bs, 5).astype(
            np.float32)).to(cuda)
      if labels == "position":
        y = np.eye(SEMI_POSITIONS, dtype=np.float32)[rs.randint(
            0, SEMI_POSITIONS, (k, bs))]
      else:
        y = rs.randint(0, 40, (k, bs, 5)).astype(np.float32)
      mask = np.zeros((k, bs), np.float32)
      mask[:, :bs // 2] = 1
      y[:, bs // 2:] = 0
      return x, torch.from_numpy(y).to(cuda), torch.from_numpy(mask).to(cuda)
    return make

  models = [(n, f, bs, batches_of(lab)) for n, f, bs, lab in zoo_models()]
  models += [(n, f, bs, batches_of(ds)) for n, f, bs, ds, _ in semi_models()]
  models += [(n, f, HIER_BATCH, batches_of(p and f"pair-{p}"))
             for n, f, p, _ in hier_models() if n != "BetaVAE"]
  models = [m for m in models
            if not wanted or m[0] in wanted or m[0] == "BetaVAE"]

  base = None
  for name, factory, bs, make_batches in models:
    vae = factory().build(seed=SEED)
    step = vae.make_step_fn()
    k = 50
    batches = make_batches(k, bs)
    fused = scan_steps(step, k, donate=True)
    state, _ = fused(vae.state, batches)
    times = []
    for _ in range(3):
      torch.cuda.synchronize()
      t = time.perf_counter()
      state, _ = fused(state, batches)
      torch.cuda.synchronize()
      times.append(1e3 * (time.perf_counter() - t) / k)
    ms = sorted(times)[1]
    base = ms if base is None else base
    short = scan_steps(step, 10, donate=True)
    sub = tuple(b[:10] for b in batches) if isinstance(batches, tuple) \
        else batches[:10]
    state, _ = short(state, sub)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      state, _ = short(state, sub)
      torch.cuda.synchronize()
    dev_ms, n = device_busy(torch, prof)
    top = sorted(((e.key, e.device_time_total / 1e3 / 10)
                  for e in prof.key_averages()
                  if e.device_time_total > 0), key=lambda t: -t[1])[:3]
    log(f"{name} batch {bs}: {ms:.3f} ms a graphed step "
        f"({ms / base:.2f}x BetaVAE's), {n / 10:.0f} kernels and "
        f"{dev_ms / 10:.3f} ms of device time a step; top: " +
        "; ".join(f"{key[:60]} {t:.3f} ms" for key, t in top) + f"; {smi}")
    del vae, step, fused, short, state
  return 0


PHASES = tuple(range(1, 16))
# the phases whose results a phase reads: the kernel reports of 2 and 5,
# phase 7's graphed step time, phase 8's model, phase 9's wav files, phase
# 10's Gym
PHASE_NEEDS = {3: (2,), 6: (5,), 8: (7,), 10: (8,), 11: (2, 9), 15: (10,)}


def selected_phases(spec=None):
  """The phases ``--phases`` names (`spec`, e.g. '1,14'), with phase 1 (the
  build) and every phase that a chosen one reads; every phase without a
  spec, as the script runs with no argument."""
  if spec is None:
    return set(PHASES)
  chosen = {1} | {int(p) for p in str(spec).split(",") if p.strip()}
  if not chosen <= set(PHASES):
    raise SystemExit(f"chip_smoke.py --phases: no phase "
                     f"{sorted(chosen - set(PHASES))}; phases are 1-15")
  todo = list(chosen)
  while todo:
    for need in PHASE_NEEDS.get(todo.pop(), ()):
      if need not in chosen:
        chosen.add(need)
        todo.append(need)
  return chosen


def main(phases=None) -> int:
  import numpy as np
  import torch

  from odin_tpu_torch import _build, serving
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.networks.attention import MultiHeadAttention
  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference)
  from odin_tpu_torch.ops.logmel import (_launch, harmonic_frames,
                                         kernel_route, logmel,
                                         logmel_reference)
  from odin_tpu_torch.preprocessing import batch_speech_features

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is "
          "false); nothing was run", file=sys.stderr)
    return 2

  # every kernel wrapper's launch counts: "logmel" counts the launches of
  # the three K1 kernels, "logmel_fft" the power-of-two FFT kernel's share,
  # "logmel_fft_mixed" the mixed-radix kernel's; "flash_attention" counts
  # the launches of both K2 kernels, "flash_attention_mma" the tensor-core
  # kernel's share
  counters = {"logmel": (logmel, "launches"),
              "logmel_fft": (logmel, "fft_launches"),
              "logmel_fft_mixed": (logmel, "mixed_launches"),
              "flash_attention": (flash_attention, "launches"),
              "flash_attention_mma": (flash_attention, "mma_launches")}
  sources = ["logmel", "logmel_fft", "logmel_fft_mixed", "flash_attention",
             "flash_attention_mma"]
  # the K1 kernel (and its counter) that each logmel route launches
  k1_kernel = {"fft": "logmel_fft", "mixed": "logmel_fft_mixed",
               "dense": "logmel"}

  def k1_launched(before, after):
    """{route: launches} of the K1 kernels between two read_counts()."""
    d = {k: after[k] - before[k] for k in ("logmel", "logmel_fft",
                                           "logmel_fft_mixed")}
    return {"fft": d["logmel_fft"], "mixed": d["logmel_fft_mixed"],
            "dense": d["logmel"] - d["logmel_fft"] - d["logmel_fft_mixed"]}
  cuda = torch.device("cuda", 0)

  def reset_counts():
    for wrapper, attr in counters.values():
      setattr(wrapper, attr, 0)

  def read_counts():
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in counters.items()}

  with Phase("1 device and build"):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    _build.build_all(sources)
    log(f"build: {time.perf_counter() - t0:.2f} s")
  phases = selected_phases() if phases is None else phases
  log(f"phases: {sorted(phases)}")
  # phase 9's corpus is written by a child process while phases 2-8 run;
  # it is stopped at exit whatever happens
  writer = None
  if 9 in phases:
    writer = start_corpus_writer()
    atexit.register(lambda: (writer.poll() is None and writer.kill(),
                             writer.wait()))

  cfg = FeatureConfig()
  batch, seconds = 64, 4.0
  T = int(seconds * cfg.sr)
  n_main = batch * cfg.n_frames(T)  # 25,472 frames: the speech path's shape
  report = {}

  # Whisper's framing (n_fft 400, 80 mels, filters from 0 Hz: the
  # mixed-radix kernel) and 25 ms frames at 22,050 Hz (n_fft 551, odd: the
  # dense kernel)
  whisper = FeatureConfig(n_fft=400, n_mels=80, fmin=0.0)
  sr22k = FeatureConfig(sr=22050, frame_length=551, step_length=220,
                        n_fft=551, n_mels=80, fmin=0.0)

  if 2 in phases:
    with Phase("2 K1 logmel against its plain version"):
      gen = torch.Generator(device=cuda).manual_seed(SEED)
      # n_fft 1024 (513 bins), 1024-sample frames folded into n_fft 512, and
      # n_fft 8192 (the FFT kernel's largest, one block an SM)
      big = FeatureConfig(frame_length=1024, step_length=256, n_fft=1024)
      folded = FeatureConfig(frame_length=1024, step_length=256, n_fft=512)
      widest = FeatureConfig(frame_length=8192, step_length=2048, n_fft=8192,
                             n_mels=80)
      n_widest = n_main // 8  # 3,184 frames of 8,192 samples
      # the mixed-radix kernel's other framings: 30 ms at 16 kHz, 25 ms at
      # 48 kHz, 20 ms at 44.1 kHz (n_fft/2 = 441, odd), and Whisper's n_fft
      # with frames folded into it and padded to it
      mixed_cfgs = [
          FeatureConfig(frame_length=480, step_length=160, n_fft=480),
          FeatureConfig(sr=48000, frame_length=1200, step_length=480,
                        n_fft=1200),
          FeatureConfig(sr=44100, frame_length=882, step_length=441,
                        n_fft=882),
          FeatureConfig(frame_length=1000, step_length=160, n_fft=400,
                        n_mels=80, fmin=0.0),
          FeatureConfig(frame_length=300, step_length=160, n_fft=400,
                        n_mels=80, fmin=0.0)]

      def check(config, n, kernel):
        """Both signals through `logmel`, which must launch `kernel`; the
        largest difference from the plain version, in dB."""
        bases = config.device_bases(cuda)
        noise = (torch.randn(n, config.frame_length, device=cuda,
                             generator=gen) * 0.1 * bases["window"]
                 ).contiguous()
        err = 0.0
        harmonic = harmonic_frames(n, config, seed=SEED + n, device=cuda)
        for name, frames in (("white noise", noise), ("harmonic", harmonic)):
          before = read_counts()
          got = logmel(frames, config)
          after = read_counts()
          want = logmel_reference(frames, bases["cos"], bases["sin"],
                                  bases["mel_t"], config.scale ** 2)
          torch.cuda.synchronize()
          launched = k1_launched(before, after)
          if launched != {r: int(k1_kernel[r] == kernel) for r in launched}:
            raise AssertionError(f"logmel launched {launched}, not {kernel} "
                                 "once")
          if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kernel} gave non-finite values")
          e = float((got - want).abs().max())
          log(f"{kernel} N={n} frame_length={config.frame_length} "
              f"n_fft={config.n_fft} {name}: max |kernel - plain| = "
              f"{e:.6f} dB (mel range {float(want.min()):.1f} to "
              f"{float(want.max()):.1f} dB)")
          if e > LOGMEL_TOL_DB:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"by {e} dB at N={n}, n_fft={config.n_fft} "
                                 f"on {name} (limit {LOGMEL_TOL_DB})")
          err = max(err, e)
        return err

      errs = {"logmel_fft": max(check(cfg, n_main, "logmel_fft"),
                                check(cfg, 1000, "logmel_fft"),
                                check(big, n_main, "logmel_fft"),
                                check(folded, n_main, "logmel_fft"),
                                check(widest, n_widest, "logmel_fft")),
              "logmel_fft_mixed": max(
                  [check(whisper, n_main, "logmel_fft_mixed"),
                   check(whisper, 1000, "logmel_fft_mixed")] +
                  [check(c, n_main, "logmel_fft_mixed") for c in mixed_cfgs]),
              "logmel": check(sr22k, n_main, "logmel")}

      def k1_bound(config, n):
        """The function's own bound, not that of a kernel's algorithm: a real
        FFT of n_fft points (2.5 n log2 n flop, the usual count for real
        input) gives the spectrum, then the power (3 flop a bin), the mel
        product over the filters' nonzero weights (counted on this run's
        filter bank) and the log.  The bytes are the frames and the filter
        bank read once and the mels written once."""
        n_freqs = config.n_fft // 2 + 1
        mel_nnz = int(torch.count_nonzero(config.device_bases(cuda)["mel_t"]))
        flops = n * (2.5 * config.n_fft * math.log2(config.n_fft) +
                     3 * n_freqs + 2 * mel_nnz + config.n_mels)
        nbytes = 4 * (n * (config.frame_length + config.n_mels) +
                      n_freqs * config.n_mels)
        ops_ms = flops / FP32_PEAK_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes,
                mel_nnz)

      def timings(config, kernel, n=n_main):
        """The kernel, its plain version and rfft + mel on n frames of white
        noise, with the bound, logged; returns the frames and the kernel's
        entry."""
        bases = config.device_bases(cuda)
        mel_t, scale_sq = bases["mel_t"], config.scale ** 2
        frames = (torch.randn(n, config.frame_length, device=cuda,
                              generator=gen) * 0.1 * bases["window"]
                  ).contiguous()

        def library():
          x = frames
          if config.frame_length > config.n_fft:  # fold, as JAX's bases do
            x = torch.nn.functional.pad(x, (0, -config.frame_length %
                                            config.n_fft))
            x = x.view(n, -1, config.n_fft).sum(1)
          spec = torch.fft.rfft(x, n=config.n_fft)
          power = (spec.real ** 2 + spec.imag ** 2) * scale_sq
          return 10.0 * torch.log10(torch.clamp(power @ mel_t, min=1e-10))

        lib_err = float((library() - logmel(frames, config)).abs().max())
        kernel_ms = cuda_ms(torch, lambda: logmel(frames, config))
        plain_ms = cuda_ms(torch, lambda: logmel_reference(
            frames, bases["cos"], bases["sin"], mel_t, scale_sq))
        library_ms = cuda_ms(torch, library)
        bound_ms, bound_by, flops, nbytes, mel_nnz = k1_bound(config, n)
        log(f"{kernel} N={n} frame_length={config.frame_length} "
            f"n_fft={config.n_fft} n_mels={config.n_mels}: "
            f"kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (rfft+mel, "
            f"max diff {lib_err:.4f} dB) bound_ms={bound_ms:.4f} by {bound_by} "
            f"({flops:.4g} flop, {nbytes / 1e6:.2f} MB; {mel_nnz} nonzero mel "
            f"weights)")
        return frames, dict(
            name=kernel, route="cuda", source=f"odin_tpu_torch/csrc/{kernel}.cu",
            replaces="odin_tpu/ops/pallas_features.py:32", launches=None,
            max_abs_err=errs[kernel], ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)

      def dense_beside(config, frames):
        """The dense kernel on the frames an FFT kernel was timed on: its
        predecessor on that route."""
        out = torch.empty(frames.shape[0], config.n_mels, device=cuda)
        dense_ms = cuda_ms(torch, lambda: _launch("dense", frames, config,
                                                  out))
        dft_flops = (frames.shape[0] * 2 * config.frame_length *
                     (config.n_fft // 2 + 1) * 2)
        log(f"logmel (dense) N={frames.shape[0]} frame_length="
            f"{config.frame_length} n_fft={config.n_fft}: kernel_ms="
            f"{dense_ms:.4f}, its algorithm's bound "
            f"{dft_flops / FP32_PEAK_FLOPS * 1e3:.4f} ms ({dft_flops:.4g} flop "
            f"of dense DFT)")

      frames, report["logmel_fft"] = timings(cfg, "logmel_fft")
      dense_beside(cfg, frames)
      del frames
      frames, report["logmel_fft_mixed"] = timings(whisper, "logmel_fft_mixed")
      dense_beside(whisper, frames)
      del frames
      for config, n in ((big, n_main), (folded, n_main),
                        (widest, n_widest)):
        frames, _ = timings(config, "logmel_fft", n)
        del frames
      for config in mixed_cfgs[:3]:
        frames, _ = timings(config, "logmel_fft_mixed")
        del frames
      frames, report["logmel"] = timings(sr22k, "logmel")
      del frames
      torch.cuda.empty_cache()

  if 3 in phases:
    with Phase("3 speech path: batch_speech_features"):
      rs = np.random.RandomState(SEED)
      lengths = rs.randint(T // 2, T + 1, size=batch)
      lengths[0] = T
      utts = [(rs.randn(n) * 0.1 * 32768.0).clip(-32768, 32767).astype(np.int16)
              for n in lengths]
      feats = ("mspec", "mfcc", "vad")

      def speech_path(config, kernel):
        """The utterances through batch_speech_features on the card, which
        must launch `kernel` once for its one batch, against the CPU."""
        reset_counts()
        got = batch_speech_features(utts, config, features=feats,
                                    device="cuda")
        counts = read_counts()
        log(f"speech path n_fft={config.n_fft} launches: {counts}")
        launched = k1_launched({k: 0 for k in counts}, counts)
        if launched != {r: int(k1_kernel[r] == kernel) for r in launched}:
          raise AssertionError(f"the speech path at n_fft {config.n_fft} "
                               f"launched {counts}, not {kernel} once")
        report[kernel]["launches"] = launched[kernel_route(config.n_fft)]
        want = batch_speech_features(utts, config, features=feats,
                                     device="cpu")
        vad_agree = vad_total = 0
        mspec_err = mfcc_err = 0.0
        for g, w, n in zip(got, want, lengths):
          if g["mspec"].shape != (config.n_frames(int(n)), config.n_mels):
            raise AssertionError(f"mspec shape {g['mspec'].shape} for {n} "
                                 "samples")
          for k in feats:
            if g[k].shape != w[k].shape:
              raise AssertionError(f"{k}: {g[k].shape} on the card, "
                                   f"{w[k].shape} on the CPU")
          if not (np.isfinite(g["mspec"]).all() and
                  np.isfinite(g["mfcc"]).all()):
            raise AssertionError("non-finite features on the card")
          mspec_err = max(mspec_err,
                          float(np.abs(g["mspec"] - w["mspec"]).max()))
          mfcc_err = max(mfcc_err, float(np.abs(g["mfcc"] - w["mfcc"]).max()))
          vad_agree += int((g["vad"] == w["vad"]).sum())
          vad_total += g["vad"].size
        log(f"card vs CPU at n_fft {config.n_fft}: mspec max diff "
            f"{mspec_err:.6f} dB, mfcc max diff {mfcc_err:.6f}, vad agreement "
            f"{vad_agree}/{vad_total}")
        if mspec_err > LOGMEL_TOL_DB:
          raise AssertionError(f"mspec differs from the CPU by {mspec_err} dB")
        if mfcc_err > 0.05:
          raise AssertionError(f"mfcc differs from the CPU by {mfcc_err}")
        if vad_agree < 0.999 * vad_total:
          raise AssertionError(f"vad agrees on {vad_agree}/{vad_total} frames")

      speech_path(cfg, "logmel_fft")
      rounds = 10
      t_batch = host_times_s(torch, lambda: batch_speech_features(
          utts, cfg, features=feats, device="cuda"), rounds)[rounds // 2]
      # padded frames hold no audio, so the rate counts the valid ones only
      n_valid = sum(cfg.n_frames(int(n)) for n in lengths)
      log(f"speech frames/s (64 int16 utterances of 2-4 s, {n_valid} valid "
          f"frames in a padded batch of {n_main}, host to device copy "
          f"included, median of {rounds}): {n_valid / t_batch:.1f} "
          f"({t_batch * 1e3:.3f} ms per batch)")
      speech_path(whisper, "logmel_fft_mixed")
      speech_path(sr22k, "logmel")

  if 4 in phases:
    with Phase("4 serving path: dSprites beta-VAE"):
      nets = dict(get_networks("dsprites", zdim=10))
      vae = BetaVAE(beta=1.0, **nets).build(seed=1, device="cuda")
      vae_cpu = BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10)).build(
          seed=1, device="cpu")
      n_params = sum(p.numel() for p in vae.core.parameters())
      log(f"beta-VAE dSprites zdim 10, conv 32-32-64-64, proj 128: "
          f"{n_params} parameters")
      reset_counts()
      for b in (1, 256):
        x = (np.random.RandomState(SEED + b).rand(b, 64, 64, 1) < 0.5
             ).astype(np.float32)
        z = np.random.RandomState(SEED + 1000 + b).randn(b, 10).astype(np.float32)
        for name, arg, shape in (("encode_mean", x, (b, 10)),
                                 ("decode_mean", z, (b, 64, 64, 1)),
                                 ("reconstruct", x, (b, 64, 64, 1))):
          fn = getattr(serving, name)
          out = fn(vae, arg)
          if out.device.type != "cuda" or tuple(out.shape) != shape:
            raise AssertionError(f"{name} b={b}: {tuple(out.shape)} on "
                                 f"{out.device}, expected {shape} on the card")
          out = out.cpu().numpy()
          if not np.isfinite(out).all():
            raise AssertionError(f"{name} b={b}: non-finite output")
          if name != "encode_mean" and (out.min() < 0 or out.max() > 1):
            raise AssertionError(f"{name} b={b}: probabilities outside [0, 1]")
          e = float(np.abs(out - fn(vae_cpu, arg).numpy()).max())
          log(f"{name} b={b}: max |card - CPU| = {e:.3g}")
          if e > SERVING_ATOL:
            raise AssertionError(f"{name} b={b} differs from the CPU by {e}")
      log(f"serving path launches: {read_counts()}")
      x1 = (np.random.RandomState(SEED).rand(1, 64, 64, 1) < 0.5).astype("f")
      x256 = (np.random.RandomState(SEED + 1).rand(256, 64, 64, 1) < 0.5
              ).astype("f")
      for name in ("encode_mean", "reconstruct"):
        fn = getattr(serving, name)
        lat = host_times_s(torch, lambda: fn(vae, x1).cpu(), 50)
        log(f"{name} b=1 latency (host to host, 50 calls): median "
            f"{lat[25] * 1e3:.3f} ms, p80 {lat[40] * 1e3:.3f} ms")
      t256 = host_times_s(torch, lambda: serving.reconstruct(vae, x256).cpu(),
                          20)[10]
      log(f"reconstruct b=256 (host to host, median of 20): "
          f"{256 / t256:.1f} images/s ({t256 * 1e3:.3f} ms per batch)")

  if 5 in phases:
    with Phase("5 K2 flash_attention against its plain version"):
      gen = torch.Generator(device=cuda).manual_seed(SEED)

      def qkv(b, h, tq, tk, d, dtype):
        return tuple((torch.randn(b, h, t, d, device=cuda, generator=gen) * 0.5
                      ).to(dtype) for t in (tq, tk, tk))

      main = (4, 8, 4096, 4096, 64)  # the repo's benchmark width
      wide = (4, 8, 1024, 1024, 256)
      f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
      rtol = {bf16: ATTN_BF16_RTOL, f16: ATTN_FP16_RTOL}
      peak = {f32: FP32_PEAK_FLOPS, bf16: BF16_PEAK_FLOPS, f16: BF16_PEAK_FLOPS}
      entry = {f32: "flash_attention", bf16: "flash_attention_mma_bf16",
               f16: "flash_attention_mma_fp16"}
      err = {dtype: 0.0 for dtype in entry}
      cases = [(main, f32, False), (main, f32, True),
               ((1, 1, 130, 300, 16), f32, False),
               ((1, 2, 200, 200, 32), f32, True), (wide, f32, False)]
      for dtype in (bf16, f16):
        cases += [(main, dtype, False), (main, dtype, True),
                  ((1, 2, 300, 200, 100), dtype, True), (wide, dtype, False)]
      for shape, dtype, causal in cases:
        q, k, v = qkv(*shape, dtype)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        n_launches = flash_attention.launches - before
        want = flash_attention_reference(q, k, v, shape[-1] ** -0.5, causal)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != q.shape:
          raise AssertionError(f"flash_attention gave {got.dtype} "
                               f"{tuple(got.shape)} for {dtype} {shape}")
        if not bool(torch.isfinite(got).all()):
          raise AssertionError(f"flash_attention gave non-finite values at "
                               f"{shape} {dtype} causal={causal}")
        want_launches = -(-shape[-1] // (128 if dtype == f32 else 256))
        if n_launches != want_launches:
          raise AssertionError(f"flash_attention launched {n_launches} kernels "
                               f"at {shape} {dtype}, not {want_launches}")
        diff = (got.float() - want.float()).abs()
        e = float(diff.max())
        if dtype == f32:
          tol = f"{ATTN_ATOL}"
          ok = e <= ATTN_ATOL
        else:
          tol = f"{ATTN_BF16_ATOL} + {rtol[dtype]:.3g}·|plain|"
          ok = bool((diff <= ATTN_BF16_ATOL +
                     rtol[dtype] * want.float().abs()).all())
        log(f"flash_attention (B, H, Tq, Tk, D)={shape} {dtype} causal={causal}"
            f": max |kernel - plain| = {e:.3g} (limit {tol}; max |plain| "
            f"{float(want.float().abs().max()):.3g}; {n_launches} launch(es))")
        if not ok:
          raise AssertionError(f"flash attention kernel disagrees with its "
                               f"plain version by {e} at {shape} {dtype} "
                               f"causal={causal} (limit {tol})")
        err[dtype] = max(err[dtype], e)
        del q, k, v, got, want, diff
      sdpa = torch.nn.functional.scaled_dot_product_attention
      for shape in (main, wide):
        B, H, Tq, Tk, D = shape
        flops = 4 * B * H * Tq * Tk * D  # the two products; softmax not counted
        for dtype in (f32, bf16, f16):
          q, k, v = qkv(*shape, dtype)
          nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
          lib_err = float((sdpa(q, k, v).float() -
                           flash_attention(q, k, v).float()).abs().max())
          kernel_ms = cuda_ms(torch, lambda: flash_attention(q, k, v))
          plain_ms = cuda_ms(torch, lambda: flash_attention_reference(
              q, k, v, D ** -0.5, False))
          library_ms = cuda_ms(torch, lambda: sdpa(q, k, v))
          ops_ms = flops / peak[dtype] * 1e3
          bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
          bound_ms = max(ops_ms, bytes_ms)
          bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
          log(f"flash_attention {shape} {dtype} non-causal: "
              f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (scaled_dot_product_attention, max "
              f"diff {lib_err:.3g}) bound_ms={bound_ms:.4f} by {bound_by} "
              f"({flops:.4g} flop at {peak[dtype] / 1e12:.0f} TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
          if shape == main and dtype == f32:
            log(f"  beside it: TF32 tensor cores would bound it at "
                f"{flops / TF32_PEAK_FLOPS * 1e3:.4f} ms but do not hold "
                f"{ATTN_ATOL}; bf16 tensor cores at "
                f"{flops / BF16_PEAK_FLOPS * 1e3:.4f} ms")
          if shape == main:
            report[entry[dtype]] = dict(
                name=entry[dtype], route="cuda",
                source="odin_tpu_torch/csrc/" + (
                    "flash_attention.cu" if dtype == f32
                    else "flash_attention_mma.cu"),
                replaces="odin_tpu/ops/pallas_attention.py:35", launches=None,
                max_abs_err=err[dtype], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
          del q, k, v
      torch.cuda.empty_cache()

  if 6 in phases:
    with Phase("6 attention path: MultiHeadAttention(flash=True)"):
      B, T, F = 4, 4096, 512

      def mha(flash, device):
        m = MultiHeadAttention(num_heads=8, qkv_features=512, flash=flash)
        m.build((T, F), torch.Generator().manual_seed(SEED), device=device)
        return m

      flash_mha, plain_mha = mha(True, cuda), mha(False, cuda)
      x_np = np.random.RandomState(SEED).randn(B, T, F).astype(np.float32)
      x = torch.from_numpy(x_np).to(cuda)
      reset_counts()
      with torch.no_grad():
        out = flash_mha(x)
      torch.cuda.synchronize()
      counts = read_counts()
      log(f"attention path forward launches: {counts}")
      if counts["flash_attention"] != 1 or counts["flash_attention_mma"] != 0:
        raise AssertionError("an fp32 MultiHeadAttention(flash=True) forward "
                             "launched the flash attention kernels "
                             f"{counts}, not the fp32 kernel once")
      report["flash_attention"]["launches"] = counts["flash_attention"]
      if out.device != cuda or tuple(out.shape) != (B, T, F):
        raise AssertionError(f"MultiHeadAttention gave {tuple(out.shape)} on "
                             f"{out.device}, expected {(B, T, F)} on the card")
      if not bool(torch.isfinite(out).all()):
        raise AssertionError("MultiHeadAttention gave non-finite values")
      with torch.no_grad():
        e = float((out - plain_mha(x)).abs().max())
      log(f"flash=True against flash=False on the card, T={T}: max diff "
          f"{e:.3g} (limit {ATTN_ATOL})")
      if e > ATTN_ATOL:
        raise AssertionError(f"flash=True differs from flash=False by {e}")
      t_cpu = 1024
      with torch.no_grad():
        got = flash_mha(torch.from_numpy(x_np[:, :t_cpu]).to(cuda)).cpu()
        want = mha(True, "cpu")(torch.from_numpy(x_np[:, :t_cpu]))
      e = float((got - want).abs().max())
      log(f"card against CPU, T={t_cpu}: max diff {e:.3g} "
          f"(limit {ATTN_CPU_ATOL})")
      if e > ATTN_CPU_ATOL:
        raise AssertionError(f"the card differs from the CPU by {e}")
      w = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
          B, T, F).astype(np.float32)).to(cuda)

      def step(m):
        m.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_()
        (m(xg) * w).sum().backward()
        return xg.grad

      reset_counts()
      gx = step(flash_mha)
      torch.cuda.synchronize()
      counts = read_counts()
      log(f"attention path forward+backward launches: {counts}")
      if counts["flash_attention"] != 1:
        raise AssertionError("a forward+backward launched the flash attention "
                             f"kernel {counts['flash_attention']} times, not "
                             "once")
      gx_plain = step(plain_mha)
      errs = {"x": float((gx - gx_plain).abs().max())}
      for (name, a), b in zip(flash_mha.named_parameters(),
                              plain_mha.parameters()):
        errs[name] = float((a.grad - b.grad).abs().max())
      log("gradients, flash=True against flash=False on the card, max diff: " +
          ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) +
          f" (limit {ATTN_GRAD_ATOL})")
      bad = {k: v for k, v in errs.items() if not v <= ATTN_GRAD_ATOL}
      if bad:
        raise AssertionError(f"gradients differ beyond {ATTN_GRAD_ATOL}: {bad}")
      rounds = 10
      for name, m in (("flash=True", flash_mha), ("flash=False", plain_mha)):
        with torch.no_grad():
          fwd = host_times_s(torch, lambda: m(x), rounds)[rounds // 2]
        both = host_times_s(torch, lambda: step(m), rounds)[rounds // 2]
        log(f"MultiHeadAttention {name} {(B, T, F)}, 8 heads, host to host, "
            f"median of {rounds}: forward {fwd * 1e3:.3f} ms, forward+backward "
            f"{both * 1e3:.3f} ms")
      # the layer in 16 bits: weights and input cast, so its attention takes
      # the tensor-core kernel; held against the fp32 layer beside the plain
      # layer in the same dtype (both round their inputs and projections)
      with torch.no_grad():
        want = flash_mha(x)
        for dtype, name in ((torch.bfloat16, "flash_attention_mma_bf16"),
                            (torch.float16, "flash_attention_mma_fp16")):
          flash_16 = mha(True, cuda).to(dtype)
          flash_16.load_state_dict(flash_mha.state_dict())
          plain_16 = mha(False, cuda).to(dtype)
          plain_16.load_state_dict(flash_mha.state_dict())
          x16 = x.to(dtype)
          reset_counts()
          out = flash_16(x16)
          torch.cuda.synchronize()
          counts = read_counts()
          log(f"attention path forward in {dtype}, launches: {counts}")
          if counts["flash_attention"] != 1 or \
              counts["flash_attention_mma"] != 1:
            raise AssertionError(f"a {dtype} MultiHeadAttention(flash=True) "
                                 "forward launched the flash attention kernels "
                                 f"{counts}, not the 16-bit kernel once")
          report[name]["launches"] = counts["flash_attention_mma"]
          if out.dtype != dtype or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"the {dtype} layer gave {out.dtype} or "
                                 "non-finite values")
          e_flash = float((out.float() - want).abs().max())
          e_plain = float((plain_16(x16).float() - want).abs().max())
          log(f"{dtype} layer against the fp32 layer, T={T}: flash=True max "
              f"diff {e_flash:.3g}, flash=False {e_plain:.3g} (limit "
              f"2 x flash=False's)")
          if e_flash > 2 * e_plain:
            raise AssertionError(f"the {dtype} flash layer is {e_flash} from "
                                 f"fp32, the plain one {e_plain}")
          fwd = host_times_s(torch, lambda: flash_16(x16), rounds)[rounds // 2]
          fwd_plain = host_times_s(torch, lambda: plain_16(x16),
                                   rounds)[rounds // 2]
          log(f"MultiHeadAttention {dtype} {(B, T, F)}, host to host, median "
              f"of {rounds}: forward flash=True {fwd * 1e3:.3f} ms, "
              f"flash=False {fwd_plain * 1e3:.3f} ms")
          del flash_16, plain_16, x16, out

  if 7 in phases:
    with Phase("7 training path: beta-VAE dSprites training step"):
      graphed_s = training_path(torch, np, reset_counts, read_counts, smi)

  if 8 in phases:
    with Phase("8 fit path: the README quickstart's training"):
      trained = fit_path(torch, np, reset_counts, read_counts, smi, graphed_s)

  if 9 in phases:
    with Phase("9 corpus path: DeviceCorpusProcessor, AudioFeatureLoader, "
               "streaming, Griffin-Lim"):
      corpus_path(torch, np, reset_counts, read_counts, smi, writer)

  if 10 in phases:
    with Phase("10 gym path: the README quickstart's DisentanglementGym"):
      gym = gym_path(torch, np, reset_counts, read_counts, smi, trained)

  if 11 in phases:
    with Phase("11 speaker path: the README's speaker quickstart"):
      k1 = speaker_path(torch, np, reset_counts, read_counts, smi)
      log(f"K1 FFT launches on the main paths: speech (phase 3) "
          f"{report['logmel_fft']['launches']}, speaker (phase 11) {k1}")
      report["logmel_fft"]["launches"] += k1

  if 12 in phases:
    with Phase("12 zoo path: the unsupervised VAE zoo on dSprites"):
      zoo_path(torch, np, reset_counts, read_counts, smi)

  if 13 in phases:
    with Phase("13 semi path: the semi-supervised VAE family on dSprites"):
      semi_path(torch, np, reset_counts, read_counts, smi)

  if 14 in phases:
    with Phase("14 hier path: the hierarchical and grouped VAE families on "
               "dSprites"):
      hier_path(torch, np, reset_counts, read_counts, smi)

  if 15 in phases:
    with Phase("15 clustering path: the Gym's clustering scores, "
               "correlations, discretizations and plots; KMeansJax, k-NN, "
               "DBSCAN, naive Bayes"):
      clustering_path(torch, np, reset_counts, read_counts, smi, gym)

  log("kernels: " + "; ".join(
      f"{k} launches={v['launches']} ms={v['ms']:.4f} "
      f"plain_ms={v['plain_ms']:.4f} library_ms={v['library_ms']:.4f} "
      f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']})"
      for k, v in report.items()))
  log(f"total wall time: {time.perf_counter() - T_START:.2f} s")
  log(smi)
  print(json.dumps({"kernels": list(report.values())}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == ["--write-corpus"]:
    write_corpus(sys.argv[2])
    sys.exit(0)
  if sys.argv[1:2] == ["--zoo-profile"]:
    sys.exit(zoo_profile(sys.argv[2:]))
  if sys.argv[1:2] == ["--semi-rehearsal"]:
    sys.exit(semi_rehearsal(sys.argv[2:]))
  if sys.argv[1:2] == ["--hier-rehearsal"]:
    sys.exit(hier_rehearsal(sys.argv[2:]))
  if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
    sys.exit(main(selected_phases(sys.argv[2])))
  if sys.argv[1:]:
    raise SystemExit(f"chip_smoke.py: unknown arguments {sys.argv[1:]}")
  sys.exit(main())
