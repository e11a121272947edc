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
     200 steps, ``log.jsonl`` in a directory under ``build/`` and
     non-blocking checkpoints: 300 steps at ``steps_per_call=1`` (a graph
     of one step a call) and 400 at ``steps_per_call=100`` (the held-out
     loss below half its start), each log's records at the steps expected
     and its last checkpoint restored bitwise equal to the state; then
     ``fit_device_dataset`` 200 + 200 steps split by a checkpoint and
     ``load_weights``, bitwise equal to 400 unbroken steps (cuDNN's
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
     (``fit`` at ``steps_per_call=100``, 400 steps):
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
     (rtol 1e-4 of each term's largest magnitude), 100 steps of
     ``vae.fit(..., steps_per_call=100)`` at batch 64 (128 for the two
     FactorVAEs, which split it) with no update skipped and the held-out
     loss below its start, steps/s (after a discarded warm-up fit), and
     ``run_model`` with MIG on 2,000 test images (not for the VQ-VAE,
     whose latents are a code map); then
     FactorVAE at Kim & Mnih's dSprites setting (tc_coef 35, the 5 x 1000
     discriminator) for 500 steps, ``DisentanglementGym(dataset=ds,
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
     100 steps of ``fit`` at ``steps_per_call=100`` (JAX's defaults: the
     Semafo family's MI term trains from step 1,000; Adam at 1e-3, and at
     1e-4 for MultitaskVAE, whose latents blow up at 1e-3) with no update
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
     step beside BetaVAE's, 100 steps of ``fit`` at
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
 16. the extractor path, on the first 256 of phase 9's wav files (it runs
     right after phase 11, before the corpus is removed): the native IO
     engine built with g++ from ``csrc/odin_io.cpp`` into ``build/``,
     ``decode_wav``, ``pack_batch`` and ``gather`` equal to ``read_wave``,
     the padded NumPy block and fancy indexing bit for bit, with the time
     of ``pack_batch`` and of the Python decode; ``FeatureProcessor`` with
     AudioReader -> PreEmphasis -> STFT -> power -> 40 mels -> 13 MFCCs ->
     CalculateEnergy -> SADgmm -> MFCC + Δ + ΔΔ -> AcousticNorm
     (``extractor_recipe``) at ``ncpu=4`` (workers forked beside the card's
     context) and ``ncpu=1``, the two stores equal bit for bit per
     utterance, the sums the float64 sums of the rows, ``log.txt`` with 0
     errors, files/s and frames/s of each; the NumPy DSP path at
     ``FeatureConfig``'s settings against ``batch_speech_features`` on the
     first 64 files (one K1 launch: mspec within 0.01 dB, mfcc and deltas
     within 0.05); ``BNFExtractor(device="cuda", stack_context=10,
     batch_size=2048)`` with SAD on the 256 utterances, a network of 819 ->
     5 x Linear(1024) + ReLU -> Linear(80) random from the seed, the first
     16 utterances against the CPU within 1e-4 of the largest output, its
     frames/s and the ms a batch of 2048; and ``FeatureProcessor(ncpu=4)``
     holding that stage refused with ``ValueError`` before it forks.
 17. the sweep path, what every script in ``examples/vae/`` runs, on
     ``Shapes3D()``'s default draws (8,192 train and 8,192 test images
     rendered on the host, the train split on the card as uint8; the full
     480,000-image grid is checked on the CPU at a reduced size,
     tests/test_torch_fullgrid.py): ``BetaVAE`` on
     ``get_networks('shapes3d')`` and on ``get_networks('locatello',
     n_channels=3)`` at batch 64, 3 steps on the card against the CPU on
     the same batches and noise at phase 7's limits;
     ``multiseed_device_dataset_steps`` with 4 seeds (one vmapped CUDA
     graph), 5 steps, lane 1 within 1e-5 of ``device_dataset_steps(seed=
     1)`` and the lanes apart, then 200 steps a call (one warm-up call and
     3 timed) beside the solo graph's step, each lane's held-out loss below
     its start; the graphed step under ``remat='dots_saveable'`` and
     ``True`` beside the plain one (peak memory, ms a step, the gradients
     bitwise with cuDNN's deterministic algorithms); ``run_hydra`` in the
     process over ``vae=betavae,betatcvae`` at beta 4, each point ``fit``
     200 steps at ``steps_per_call=100``, ``run_model(n_samples=2000)``,
     ``write_report(scores=('mig', 'sap', 'dci'))`` and
     ``ScoreBoard.write``, both rows read back and both output
     directories found; then ``-j2`` refused once CUDA has started.  The
     path launches no kernel of this port.  ``python3 chip_smoke.py
     --multiseed-profile [LANES [K]]`` runs only a profile of the
     multi-seed step against the solo one (``multiseed_profile``);
     ``--trunk-conditioning [STEPS]`` (on the CPU) measures how far float32
     rounding moves each trunk's training against float64
     (``trunk_conditioning``).
 18. the last VAE classes (``last_path``), each ``fit`` at
     ``steps_per_call=100`` on the graphed step: ``examples/
     topic_model.py``'s recipe through ``run_hydra`` (``SyntheticBoW(2000
     docs, 200 words, 8 topics)``, ``amortizedLDA``, 2000 steps at batch
     64) swept over seeds 1-3, the medians of its test perplexity and
     topic best-match cosine held to the JAX package's over 21 seeds on
     the CPU (``tests/recipe_seeds.py``); ``nonlinearLDA``, ``ALDA`` and
     ``auxiliaryLDA(n_labels=8)`` (10 % of the documents labelled) 100
     steps each; ``examples/grade_membership.py``'s recipe
     (``fit_device_dataset``, 600 steps at batch 256) at seeds 0-20, the
     medians of its held-out accuracy and membership purity held to the
     JAX package's; ``CycleConsistentVAE`` on
     2,048 rendered dSprites pairs that share their shape and
     ``MoeVAE`` on the image and the 5 factor values of 2,048 draws, 100
     steps each, then ``cycle_consistency`` and ``cross_generate`` finite;
     ``VariationalRNN``, ``SequentialVAE`` and ``SequentialAttentionVAE``
     at their defaults, 100 steps each on segments of 64 frames of the
     40-mel log-mels of 64 int16 utterances of 2-4 s (one feature batch,
     one K1 launch, the log-mels within 0.01 dB of the CPU).  Each class:
     its ELBO terms and loss gradients on the card against the CPU on the
     trained params, one batch and one set of noise (1e-4 of each term's,
     each tensor's, largest magnitude); no update skipped; the held-out
     loss below its start; steps/s, a graphed step's kernels and device
     time (``torch.profiler``) and the capture time.
     ``python3 chip_smoke.py --last-rehearsal`` runs the phase on the CPU
     (``last_rehearsal``);
 19. the natural-image VAEs (``images_path``): a child process started
     with the script writes MNIST-, CIFAR-10- and CelebA-shaped ``.npz``
     files (``write_images``: YDisentanglement renders at 28 x 28, 60,000
     train and 10,000 test; Shapes3D renders downsampled to 32 x 32 x 3,
     50,000 and 10,000; 64 x 64 x 3 renders with 40 attributes, 8,192 and
     1,024), loaded with ``get_dataset``; ``BetaVAE`` on
     ``mnist_networks`` and ``cifar10_networks`` (qlogistic) at batch 64
     and ``get_optimizer_info``'s schedule, 500 steps each; cifar10 with
     ``resnet=True``, with a Gaussian likelihood, with the skip-generator
     decoder, a PixelCNN decoder with the 10-component 'mixqlogistic' head
     (``pixelcnn_networks``) and ``MultitaskVAE`` on
     ``celeba_networks(is_semi_supervised=True)``, 100 steps each.  Each:
     the ELBO terms and gradients on the card against the CPU on its fresh
     weights (16 held-out rows; 1e-4 of each term's largest magnitude,
     2e-3 of each gradient tensor's, 2e-2 for the mixture head's: cuDNN's
     5x5 convolutions and float32's own rounding, measured by
     ``tools/image_grad_precision.py``), the held-out loss below its
     start, no update skipped, steps/s; the recipes' graphed step (kernels, device time).
     Then ``SpaceToDepthConv`` against ``Conv(k4, s2)`` and
     ``ConvTranspose(subpixel=True)`` against the plain one at dSprites'
     widths, within 1e-5 of the largest output.  It launches no kernel of
     the port.  ``python3 chip_smoke.py --images-rehearsal`` runs the
     phase on the CPU on smaller files (``images_rehearsal``);
 20. the distribution zoo and the gene-expression VAEs (``genes_path``):
     every family of the slice (the 7 continuous and 10 discrete ones, a
     ZeroInflated NBDisp, ConditionalTensor, Batchwise) on the card
     against the CPU (log_prob, mean, variance, entropy and 9 registered
     KL pairs, 1e-5 of each result's largest magnitude) and by the sample
     moments of 10^5 draws on the card (5 standard errors); Cortex's and
     PBMC's ``.npz`` files written from ``SyntheticGenes`` (558 genes, 7
     types; 1000 and 4; 5,000 cells) and read with ``get_dataset``;
     ``VariationalAutoencoder(**get_networks("cortex"))`` and
     ``M2VAE(**get_networks("pbmc", is_semi_supervised=True))`` (10 % of
     the cells labelled) 500 steps each of ``fit`` at batch 64 with
     ``get_optimizer_info``'s schedule, their graphed steps profiled;
     cortex with the zinb, nb, nbd, poisson, zipoisson and 3-component
     mixzinb likelihoods, mvntril and autoregressive latents and dropout
     0.1 on the observation, and ``SyntheticATAC`` (300 regions, 5 topics,
     2,000 cells) under zibernoulli, 100 steps each.  Each: the ELBO terms
     (1e-4) and gradients (2e-3 of each tensor's largest) on the card
     against the CPU on one training-mode loss's noise, the held-out loss
     below its start, no update skipped, steps/s; the float32 ZINB
     log-likelihood against float64.  It launches no kernel of the port.
     ``python3 chip_smoke.py --genes-rehearsal`` runs it on the CPU.
 21. the x-vector path (``xvector_path``, right after phase 16, on phase
     9's 2048 wav files of 64 speakers): ``examples/voxceleb/recipe.py``'s
     lines through the port's API (``xvector_recipe``):
     ``batch_speech_features(raw, FeatureConfig(n_mels=24, n_ceps=14),
     features=("mfcc_cmvn",))`` (one K1 launch a batch of 64: 32), each
     utterance cut to the shortest one's 398 frames so that they stack,
     ``XVectorNet(n_classes=64, embedding_dim=512)`` trained 1200 steps at
     batch 32 by the port's ``AdamW(1e-3, weight_decay=1e-4)`` on batches
     drawn by ``RandomState(1)``, every utterance's embedding, ``PLDA(
     n_phi=16, n_iter=8)`` on speakers 0-31 and 2000 trials on speakers
     32-63: the loss finite and falling, the PLDA EER under a limit set
     from the CPU at a reduced scale, minDCF; one step from the initial
     weights on the first batch on the card against the CPU (loss,
     logits, embeddings, gradients, at about 100x the CPU's float32
     distance from float64, ``tools/xvector_recipe.py``); then each class
     of ``networks/time_delay.py``, ``util_layers.py`` and ``dropout.py``
     at small shapes on the card against the CPU (outputs within 1e-5,
     cuDNN's recurrent layers' within 5e-5, and gradients within 1e-4 of
     their largest magnitudes),
     ``BatchRenormalization``'s statistics after three training calls,
     and the dropouts' dropped shares within 5 binomial standard errors of
     their rates.  Logged: the features' seconds, the median ms a step and
     the kernels a step, the embedding and PLDA seconds, EER and minDCF.
     The network runs cuDNN and cuBLAS; K1 is the path's port kernel.

The datasets' files and caches are kept under ``build/odin_tpu_home``
(``$ODIN_TPU_HOME``).  Run with no argument, it runs every phase: the
whole check.  ``python3 chip_smoke.py --phases 1,14`` runs the phases
named (1-21), phase 1 (the build) always, and every phase whose results a
named one reads (``PHASE_NEEDS``: 3 reads 2, 6 reads 5, 8 reads 7, 10
reads 8, 11 reads 2 and 9, 15 reads 10, 16 and 21 read 9; 17, 18, 19
and 20 read none); its ``kernels`` line lists only the kernels those
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
FIT_K1_TIMED = 300
FIT_K = 100
FIT_STEPS = 400
FIT_VALID = 200  # the k = 100 run's validation and checkpoint interval
FIT_DD_CALL = 200
FIT_TIMED = 300  # the timed repeat at k = 100


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

  # -- 8.2 steps_per_call=100 for 400 steps: learning, logs, checkpoint
  vae2 = quickstart()
  eval_fn = vae2.make_eval_fn()
  before = float(eval_fn(vae2.state, held)["loss"])
  logdir = os.path.join(root, "k100")
  tr2 = vae2.fit(train(), valid=valid, max_iter=FIT_STEPS,
                 valid_freq=FIT_VALID, logdir=logdir, logging_interval=0.0,
                 checkpoint_freq=FIT_VALID,
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
      valid_steps != list(range(FIT_VALID, FIT_STEPS + 1, FIT_VALID)):
    raise AssertionError(f"log.jsonl has train {train_steps} and valid "
                         f"{valid_steps}")
  back = tr2.restore_checkpoint()
  bad = same_state(back, vae2.state)
  log(f"checkpoint at step {int(back.step)} restored: "
      f"{'bitwise equal to the state' if not bad else bad}")
  if bad or int(back.step) != FIT_STEPS:
    raise AssertionError(f"the checkpoint differs from the state: {bad}")

  k100_s = timed(FIT_K, FIT_TIMED)

  # -- 8.3 fit_device_dataset: 2 x 200 steps split by a checkpoint against
  # 400 unbroken.  cuDNN's deterministic algorithms, so that both runs
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
                     f"call, validation and a checkpoint every {FIT_VALID} "
                     "steps",
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
  # the wav files stay for phase 16; main removes the corpus after it
  shutil.rmtree(cache, ignore_errors=True)
  return counts["logmel_fft"]


# phase 16: the extractor path on the first 256 of phase 9's wav files
EXT_FILES = 256
EXT_NCPU = 4
EXT_FORK_LIMIT_S = 300  # the forked run ends with an error past this
EXT_K1_FILES = 64  # one batch of batch_speech_features: one K1 launch
EXT_MFCC_TOL = 0.05  # tests/test_ops_features.py:35-38, mfcc and deltas
EXT_SUM1_REL = 1e-5  # sum1: float32 sums of each utterance's rows, added
EXT_SUM2_REL = 1e-9  # in float64; sum2: float64 sums, another order
EXT_GATHER_ROWS = 256  # rows of the packed block, drawn with replacement
BNF_CONTEXT = 10  # 21 stacked frames of the 39-column MFCC + Δ + ΔΔ: 819
BNF_HIDDEN, BNF_LAYERS, BNF_DIM = 1024, 5, 80
BNF_BATCH = 2048
BNF_CPU_FILES = 16
BNF_REL = 1e-4  # card against CPU, of the largest output magnitude


def extractor_recipe(P):
  """Phase 16's extractor pipeline from `P`, the port's preprocessing:
  the issue's stages in order (13 MFCCs, so that MFCC + Δ + ΔΔ is 39
  wide), with a Framing stage to give CalculateEnergy its frames and a
  Delete stage to keep the raw audio, the frames and the spectra out of
  the store."""
  return P.make_pipeline([
      P.AudioReader(sr=CORPUS_SR), P.PreEmphasis(),
      P.STFTExtractor(n_fft=512, window="hamm", energy=False),
      P.PowerSpecExtractor(), P.MelsSpecExtractor(n_mels=40),
      P.MFCCsExtractor(n_ceps=13), P.Framing(), P.CalculateEnergy(),
      P.SADgmm(), P.DeltaExtractor(input_name=("mfcc",), order=(0, 1, 2)),
      P.AcousticNorm(input_name=("mspec", "mfcc")),
      P.Delete(("raw", "frames", "stft", "spec"))])


def bnf_network(torch):
  """819 -> 5 x (Linear(1024) + ReLU) -> Linear(80), random from SEED."""
  torch.manual_seed(SEED)
  width = 39 * (2 * BNF_CONTEXT + 1)
  layers = []
  for _ in range(BNF_LAYERS):
    layers += [torch.nn.Linear(width, BNF_HIDDEN), torch.nn.ReLU()]
    width = BNF_HIDDEN
  return torch.nn.Sequential(*layers, torch.nn.Linear(width, BNF_DIM))


def extractor_path(torch, np, reset_counts, read_counts, smi):
  """Phase 16: the native IO engine, FeatureProcessor over forked workers
  beside the card's context, the NumPy DSP path against K1 and
  BNFExtractor on the card, on the first 256 of phase 9's wav files (see
  the docstring); returns K1's FFT launches on the path."""
  import copy
  import glob
  import multiprocessing
  import os
  import shutil
  import signal
  from odin_tpu_torch import native
  from odin_tpu_torch.fuel.dataset import Dataset
  from odin_tpu_torch import preprocessing as P
  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.preprocessing import signal as S
  from odin_tpu_torch.preprocessing.speech import read_wave, read_wave_raw

  root = corpus_root()
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))[:EXT_FILES]
  if len(files) != EXT_FILES:
    raise AssertionError(f"{len(files)} of phase 9's wav files left, not "
                         f"{EXT_FILES}")
  work = os.path.join(root, "extractor")
  shutil.rmtree(work, ignore_errors=True)

  # -- 16.1 the native IO engine, built with g++ from the port's source
  if not native.native_available():
    raise AssertionError("the native IO engine did not build or load")
  lib = os.path.realpath(native.library_file())
  build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
  if not lib.startswith(os.path.realpath(build) + os.sep):
    raise AssertionError(f"the native library {lib} is not under build/")
  t0 = time.perf_counter()
  decoded = [read_wave(f) for f in files]
  t_read = time.perf_counter() - t0
  max_samples = max(len(y) for y, _ in decoded)
  t0 = time.perf_counter()
  block = np.zeros((EXT_FILES, max_samples), np.float32)
  for i, (y, _) in enumerate(decoded):
    block[i, :len(y)] = y
  t_python = t_read + time.perf_counter() - t0
  t0 = time.perf_counter()
  natives = [native.decode_wav(f) for f in files]
  t_decode = time.perf_counter() - t0
  for f, (y, sr), (y_n, sr_n) in zip(files, decoded, natives):
    if sr != sr_n or y.dtype != y_n.dtype or not np.array_equal(y, y_n):
      raise AssertionError(f"decode_wav differs from read_wave on {f}")
  t0 = time.perf_counter()
  packed, lengths, srs = native.pack_batch(files, max_samples)
  t_pack = time.perf_counter() - t0
  if not (np.array_equal(packed, block) and
          np.array_equal(lengths, [len(y) for y, _ in decoded]) and
          np.all(srs == CORPUS_SR)):
    raise AssertionError("pack_batch differs from the padded NumPy block")
  idx = np.random.RandomState(SEED).randint(0, EXT_FILES, EXT_GATHER_ROWS)
  t0 = time.perf_counter()
  gathered = native.gather(packed, idx)
  t_gather = time.perf_counter() - t0
  t0 = time.perf_counter()
  fancy = packed[idx]
  t_fancy = time.perf_counter() - t0
  if not np.array_equal(gathered, fancy):
    raise AssertionError("gather differs from fancy indexing")
  log(f"native IO ({lib}): decode_wav, pack_batch and gather equal to "
      f"read_wave, the padded block and fancy indexing, bit for bit, on "
      f"{EXT_FILES} files of up to {max_samples} samples")
  log(f"pack_batch of {EXT_FILES} files: {1e3 * t_pack:.3f} ms (host clock)")
  log(f"Python decode (read_wave of {EXT_FILES} files, then the padded "
      f"block): {1e3 * t_python:.3f} ms (host clock)")
  log(f"decode_wav of {EXT_FILES} files one by one: {1e3 * t_decode:.3f} ms "
      f"(host clock)")
  log(f"gather of {EXT_GATHER_ROWS} rows of {max_samples} float32: "
      f"{1e3 * t_gather:.3f} ms; fancy indexing {1e3 * t_fancy:.3f} ms "
      f"(host clock)")
  del block, packed, gathered, fancy, natives

  # -- 16.2 FeatureProcessor at ncpu=4 (forked workers beside the card's
  # context) and inline at ncpu=1
  if not torch.cuda.is_initialized():
    raise AssertionError("the card's context is not held")
  jobs = [{"path": f, "name": os.path.basename(f)} for f in files]

  def on_alarm(signum, frame):
    raise TimeoutError(f"FeatureProcessor ran past {EXT_FORK_LIMIT_S} s")

  stores = {}
  for ncpu in (EXT_NCPU, 1):
    path = os.path.join(work, f"ncpu{ncpu}")
    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(EXT_FORK_LIMIT_S)
    try:
      t0 = time.perf_counter()
      P.FeatureProcessor(jobs, path, extractor_recipe(P), ncpu=ncpu).run()
      wall = time.perf_counter() - t0
    finally:
      signal.alarm(0)
      signal.signal(signal.SIGALRM, previous)
    if multiprocessing.active_children():
      raise AssertionError("FeatureProcessor left worker processes")
    ds = Dataset(path)
    with open(os.path.join(path, "log.txt")) as f:
      head = f.read().splitlines()[:3]
    if head != [f"jobs: {EXT_FILES}", f"processed: {EXT_FILES}",
                "errors: 0"]:
      raise AssertionError(f"FeatureProcessor(ncpu={ncpu}) log: {head}")
    n_frames = int(ds["mspec"].shape[0])
    log(f"FeatureProcessor ncpu={ncpu}, {EXT_FILES} files: {wall:.4f} s, "
        f"{EXT_FILES / wall:.2f} files/s, {n_frames / wall:.1f} frames/s "
        f"(host clock); {smi}")
    stores[ncpu] = ds
  feats = ("mspec", "mfcc", "energy", "sad")
  for feat in feats:
    a, b = stores[EXT_NCPU], stores[1]
    ia, ib = a[f"indices_{feat}"], b[f"indices_{feat}"]
    if sorted(ia) != sorted(ib) or len(ia) != EXT_FILES:
      raise AssertionError(f"indices_{feat} differ between the runs")
    for name, (s, e) in ib.items():
      sa, ea = ia[name]
      if np.asarray(a[feat][sa:ea]).tobytes() != \
          np.asarray(b[feat][s:e]).tobytes():
        raise AssertionError(f"{feat} of {name} differs between ncpu="
                             f"{EXT_NCPU} and ncpu=1")
    if feat == "sad":
      continue
    for ncpu, ds in stores.items():
      rows = np.asarray(ds[feat][:], np.float64)
      sum1 = np.load(os.path.join(ds.path, f"{feat}_sum1.npy"))
      sum2 = np.load(os.path.join(ds.path, f"{feat}_sum2.npy"))
      e1 = float(np.abs(sum1 - rows.sum(0)).max() / np.abs(rows).sum(0).max())
      e2 = float(np.abs(sum2 - (rows ** 2).sum(0)).max() /
                 (rows ** 2).sum(0).max())
      if e1 > EXT_SUM1_REL or e2 > EXT_SUM2_REL:
        raise AssertionError(f"{feat}_sum1/2 at ncpu={ncpu} are {e1:.3g} / "
                             f"{e2:.3g} from the float64 sums of the rows")
  mfcc_dim = stores[1]["mfcc"].shape[1]
  log(f"FeatureProcessor: ncpu={EXT_NCPU} and ncpu=1 stores equal bit for "
      f"bit per utterance ({', '.join(feats)}; mfcc + deltas {mfcc_dim} "
      f"wide); sum1 within {EXT_SUM1_REL} of the largest sum of |rows|, sum2 "
      f"within {EXT_SUM2_REL}; log.txt 0 errors")

  # -- 16.3 the NumPy DSP path against K1 through batch_speech_features
  cfg = FeatureConfig(sr=CORPUS_SR)
  raw = [read_wave_raw(f)[0] for f in files[:EXT_K1_FILES]]
  reset_counts()
  t0 = time.perf_counter()
  got = P.batch_speech_features(raw, cfg, batch_size=EXT_K1_FILES,
                                features=("mspec", "mfcc", "mfcc_delta"),
                                device="cuda")
  t_k1 = time.perf_counter() - t0
  counts = read_counts()
  log(f"batch_speech_features of {EXT_K1_FILES} files launches: {counts}")
  if counts["logmel"] != 1 or counts["logmel_fft"] != 1:
    raise AssertionError(f"batch_speech_features launched K1 {counts}, not "
                         "once for one batch")
  k1 = counts["logmel_fft"]
  half = cfg.delta_width // 2
  err = {"mspec": 0.0, "mfcc": 0.0, "mfcc_delta": 0.0}
  for y16, out in zip(raw, got):
    y = S.pre_emphasis(y16.astype(np.float32) / 32768.0, cfg.preemphasis)
    spec = np.abs(S.stft(y, cfg.frame_length, cfg.step_length, cfg.n_fft,
                         window=cfg.window)) ** 2
    mspec = S.mels_spectrogram(spec, cfg.sr, cfg.n_mels, fmin=cfg.fmin,
                               top_db=cfg.top_db)
    mfcc = S.ceps_spectrogram(mspec, cfg.n_ceps)
    want = {"mspec": mspec, "mfcc": mfcc,
            "mfcc_delta": S.delta(mfcc, width=cfg.delta_width, order=1)}
    for key in err:
      if out[key].shape != want[key].shape:
        raise AssertionError(f"{key}: {out[key].shape} on the card, "
                             f"{want[key].shape} in NumPy")
      # a delta's window of the last frames reaches the batch's padding
      # (both packages filter the padded batch): those frames are left out
      keep = len(want[key]) - (half if key == "mfcc_delta" else 0)
      err[key] = max(err[key], float(np.abs(out[key][:keep] -
                                            want[key][:keep]).max()))
  log(f"NumPy DSP path against K1 on {EXT_K1_FILES} files: mspec max diff "
      f"{err['mspec']:.6f} dB (limit {LOGMEL_TOL_DB}), mfcc "
      f"{err['mfcc']:.6f} (limit {EXT_MFCC_TOL}), deltas "
      f"{err['mfcc_delta']:.6f} (limit {EXT_MFCC_TOL}; all but each "
      f"utterance's last {half} frames, whose window reaches the batch's "
      f"padding); "
      f"batch_speech_features {1e3 * t_k1:.3f} ms (host clock)")
  if err["mspec"] > LOGMEL_TOL_DB or err["mfcc"] > EXT_MFCC_TOL or \
      err["mfcc_delta"] > EXT_MFCC_TOL:
    raise AssertionError(f"K1's path disagrees with the NumPy path: {err}")

  # -- 16.4 BNFExtractor on the card, its first 16 utterances on the CPU
  ds = stores[1]
  mfcc_idx, sad_idx = ds["indices_mfcc"], ds["indices_sad"]
  utts = []
  for f in files:
    name = os.path.basename(f)
    (s, e), (ss, se) = mfcc_idx[name], sad_idx[name]
    utts.append({"mfcc": np.asarray(ds["mfcc"][s:e]),
                 "sad": np.asarray(ds["sad"][ss:se]).ravel().astype(bool)})
  net = bnf_network(torch)
  cpu_net = copy.deepcopy(net)
  bnf = P.BNFExtractor("mfcc", net, stack_context=BNF_CONTEXT,
                       batch_size=BNF_BATCH, device="cuda")
  if next(bnf.network.parameters()).device.type != "cuda":
    raise AssertionError("BNFExtractor's network is not on the card")
  bnf.transform(utts[0])  # warm-up: cuBLAS's handle, the pinned pool
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  outs = [bnf.transform(u)["bnf"] for u in utts]
  t_bnf = time.perf_counter() - t0
  n_speech = sum(int(u["sad"].sum()) for u in utts)
  for u, out in zip(utts, outs):
    if out.shape != (int(u["sad"].sum()), BNF_DIM) or \
        not np.isfinite(out).all():
      raise AssertionError(f"BNF output {out.shape}, not finite "
                           f"({int(u['sad'].sum())}, {BNF_DIM})")
  cpu = P.BNFExtractor("mfcc", cpu_net, stack_context=BNF_CONTEXT,
                       batch_size=BNF_BATCH, device="cpu")
  worst = 0.0
  for u, out in zip(utts[:BNF_CPU_FILES], outs):
    want = cpu.transform(u)["bnf"]
    worst = max(worst, float(np.abs(out - want).max() /
                             np.abs(want).max()))
  x = torch.randn(BNF_BATCH, 39 * (2 * BNF_CONTEXT + 1), device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(SEED))
  with torch.inference_mode():
    ms_batch = cuda_ms(torch, lambda: bnf.network(x))
  log(f"BNFExtractor on the card, {EXT_FILES} utterances, {n_speech} speech "
      f"frames: {t_bnf:.4f} s, {n_speech / t_bnf:.1f} frames/s (host clock, "
      f"MVN, stacking and copies included); {smi}")
  log(f"BNF network (819 -> 5 x 1024 -> 80) on a batch of {BNF_BATCH}: "
      f"{ms_batch:.4f} ms (CUDA events); {smi}")
  log(f"BNF card against CPU on the first {BNF_CPU_FILES} utterances: max "
      f"diff {worst:.3g} of the largest |output| (limit {BNF_REL})")
  if worst > BNF_REL:
    raise AssertionError(f"BNF on the card is {worst} from the CPU")
  before = multiprocessing.active_children()
  refused = os.path.join(work, "refused")
  try:
    P.FeatureProcessor(jobs, refused, P.make_pipeline([
        extractor_recipe(P), bnf]), ncpu=EXT_NCPU)
  except ValueError as e:
    log(f"FeatureProcessor(ncpu={EXT_NCPU}) with BNFExtractor on the card "
        f"refused before forking: {e}")
  else:
    raise AssertionError("FeatureProcessor accepted a card stage at ncpu="
                         f"{EXT_NCPU}")
  if os.path.exists(refused) or multiprocessing.active_children() != before:
    raise AssertionError("the refused FeatureProcessor forked or wrote")
  shutil.rmtree(work, ignore_errors=True)
  return k1


# phase 12: the unsupervised VAE zoo on dSprites
ZOO_BATCH = 64
ZOO_STEPS = 100  # each class's fit: 1 call of ZOO_K graphed steps
ZOO_K = 100
ZOO_RTOL = 1e-4  # card against CPU: fp32 sums in another order, of each
# ELBO term's largest magnitude over the batch
ZOO_FACTOR_STEPS = 500  # Kim & Mnih's dSprites setting, cut in length
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
  terms on the card against the CPU, 100 steps of ``fit`` at
  ``steps_per_call=100`` (the held-out loss below its start, no update
  skipped, steps/s), ``run_model`` and MIG on 2,000 test images; then
  FactorVAE at Kim & Mnih's dSprites setting (tc_coef 35, the 5 x 1000
  discriminator) for 500 steps and the Gym's default report on 10,000
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
    # -- 12.2 fit: 100 steps in one call
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
SEMI_STEPS = 100  # each class's fit: 1 call of SEMI_K graphed steps
SEMI_K = 100
SEMI_LABELLED = 0.1  # label_percent: 1,638 of the 16,384 train images
SEMI_OVERSAMPLE = 0.5  # the labelled rows of each batch: 32 of 64
# the Semi-Factor pair's supervised term reads the second half of its batch
# (the discriminator's), so 96 of its 128 rows are labelled, 32 of them in
# that half; at 0.5 the half holds no labelled row
SEMI_FACTOR_OVERSAMPLE = 0.75
# fit's learning rate: Adam's 1e-3 but for MultitaskVAE.  Its Gaussian
# factor head reads the decoder's 4,096 image logits at alpha 10; at 1e-3
# its latents blow up at steps that hang on float rounding (the KL term
# from 25 to 5,467 within 60 steps on the phase's data order), so the
# held-out loss at step 200 fell anywhere between 0.51 and 1.18 of its
# start from one run of the script to the next.  At 1e-4 it falls
# smoothly on each of 8 data orders (tools/semi_trajectory.py)
SEMI_LR = 1e-3
SEMI_CLASS_LR = {"MultitaskVAE": 1e-4}
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
  100 steps of ``fit`` at ``steps_per_call=100`` (the held-out loss below
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
    # -- 13.2 fit: 100 steps in one call, on (x, y, mask) batches
    eval_fn = vae.make_eval_fn()
    hb = to(batch, cuda)
    start = float(eval_fn(vae.state, hb)["loss"])
    llk0 = labels_llk(vae, hx, hy)
    lr = SEMI_CLASS_LR.get(name, SEMI_LR)
    tr = vae.fit(train(data[dname], bs, share), max_iter=SEMI_STEPS,
                 steps_per_call=SEMI_K, learning_rate=lr,
                 logging_interval=1e9, verbose=False)
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
        f"(limit {SEMI_RTOL}); fit {SEMI_STEPS} steps at batch {bs}, lr "
        f"{lr:g} "
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
HIER_STEPS = 100  # each class's fit: 1 call of HIER_K graphed steps
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
  100 steps of ``fit`` at ``steps_per_call=100`` (the held-out loss below
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
    # -- 14.2 a graphed step's kernels and device time; fit: 100 steps
    # in one call
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


SWEEP_BATCH = 64  # the sweep scripts' batch (examples/vae/*.py)
SWEEP_PARITY_STEPS = 3  # card against CPU, as phase 7
# the Locatello trunk's ReLUs: a pre-activation near 0 takes the other
# gate where its sum is rounded otherwise, which moves its unit's
# gradients by far more than the rounding (``--trunk-conditioning``
# measures it against float64 on the CPU), and Adam carries that into
# the params.  So
# each step's gradients are held at the CPU's state of that step, and
# the params after 3 free steps by 2·lr a step alone, the elements beyond
# TRAIN_PARAM_ATOL counted (phase 7's share, 2e-5, for the ELU trunk)
SWEEP_SEEDS = (0, 1, 2, 3)  # S = 4 lanes, cut from Locatello et al.'s 50
SWEEP_MS_STEPS = 5  # lane against its solo run
SWEEP_MS_K = 200  # the timed multi-seed graph: steps a call
SWEEP_LANE_ATOL = 1e-5  # a lane against its solo run (tests/test_multiseed.py)
SWEEP_REMAT = ("dots_saveable", True)
SWEEP_REMAT_K = 100  # remat's timed graphs: steps a call
SWEEP_FIT_STEPS = 200  # each sweep point's fit, SWEEP_FIT_K steps a call
SWEEP_FIT_K = 100
SWEEP_BETA = 4.0  # at beta 1 the beta-TCVAE objective is the plain ELBO
SWEEP_GYM_ROWS = 2000
SWEEP_HELD = 256  # held-out test images for the lanes' losses


def sweep_path(torch, np, reset_counts, read_counts, smi):
  """Phase 17: the disentanglement sweep on Shapes3D (see the
  docstring)."""
  import os
  import shutil
  from odin_tpu_torch.bay.vi import BetaVAE, DisentanglementGym, get_vae
  from odin_tpu_torch.fuel import Shapes3D, get_dataset
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import (
      ScoreBoard, device_dataset_steps, get_output_dir,
      multiseed_device_dataset_steps, run_hydra, stack_states,
      state_from_host, state_to_host, unstack_states)

  cuda = torch.device("cuda", 0)
  B = SWEEP_BATCH

  def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out

  # -- 17.1 Shapes3D's default draws, on the card as uint8
  t0 = time.perf_counter()
  ds = Shapes3D()
  train_x = ds.numpy("train", inc_labels=False)
  test_x = ds.numpy("test", inc_labels=False)
  t_render = time.perf_counter() - t0
  corpus = torch.from_numpy((train_x * 255).astype(np.uint8)).to(cuda)
  held = torch.from_numpy(
      (test_x[:SWEEP_HELD] * 255).astype(np.uint8)).to(cuda).float() / 255
  log(f"Shapes3D(): {len(train_x)} train and {len(test_x)} test images "
      f"rendered in {t_render:.2f} s; the train split on the card as uint8 "
      f"({corpus.numel() / 1e6:.1f} MB)")

  # -- 17.2 the card against the CPU: both trunks, 3 steps, same batches
  # and noise, at phase 7's limits
  rs = np.random.RandomState(SEED)
  idx = rs.randint(0, len(train_x), (SWEEP_PARITY_STEPS, B))
  xs = (train_x[idx] * 255).astype(np.uint8).astype(np.float32) / 255
  epss = rs.randn(SWEEP_PARITY_STEPS, B, 10).astype(np.float32)
  for trunk, nets, share in (
      ("shapes3d", lambda: get_networks("shapes3d", zdim=10),
       TRAIN_FAR_SHARE),
      ("locatello", lambda: get_networks("locatello", zdim=10, n_channels=3),
       None)):
    vae = BetaVAE(beta=1.0, **nets()).build(seed=1, device=cuda)
    ref = BetaVAE(beta=1.0, **nets()).build(seed=1, device="cpu")
    step = vae.make_step_fn(learning_rate=TRAIN_LR)
    step_cpu = ref.make_step_fn(learning_rate=TRAIN_LR)
    s, s_cpu = vae.state, ref.state
    losses, grad_rel = [], 0.0
    for i in range(SWEEP_PARITY_STEPS):
      eps = torch.from_numpy(epss[i])
      # the card's gradients at the CPU's state of this step
      _, _, g = step.value_and_grad(state_from_host(state_to_host(s_cpu),
                                                    cuda), xs[i], eps=eps)
      _, _, g_cpu = step_cpu.value_and_grad(s_cpu, xs[i], eps=eps)
      grad_rel = max([grad_rel] + [
          float((g["vae"][k].cpu() - w).abs().max() /
                w.abs().max().clamp(min=1e-30))
          for k, w in g_cpu["vae"].items()])
      s, m = step(s, xs[i], eps=eps)
      s_cpu, m_cpu = step_cpu(s_cpu, xs[i], eps=eps)
      losses.append((float(m["loss"]), float(m_cpu["loss"])))
    worst, far, total = 0.0, 0, 0
    for k, w in s_cpu.params["vae"].items():
      d = (s.params["vae"][k].cpu() - w).abs()
      worst, far = max(worst, float(d.max())), far + int(
          (d > TRAIN_PARAM_ATOL).sum())
      total += d.numel()
    log(f"BetaVAE on {trunk} ({total} params), card against CPU: each "
        f"step's gradients at the CPU's state max rel {grad_rel:.3g} (limit "
        f"{TRAIN_GRAD_REL}); losses " + ", ".join(
            f"{a:.4f}/{b:.4f}" for a, b in losses) +
        f" (limit rtol {TRAIN_LOSS_RTOL}); params after "
        f"{SWEEP_PARITY_STEPS} steps max |diff| {worst:.3g} (limit "
        f"{2 * TRAIN_LR * SWEEP_PARITY_STEPS:.3g}), {far} of {total} beyond "
        f"{TRAIN_PARAM_ATOL} (limit " +
        (f"{share} of them)" if share else "none: ReLU gates)"))
    if not grad_rel <= TRAIN_GRAD_REL:
      raise AssertionError(f"{trunk}: gradients differ by {grad_rel}")
    for a, b in losses:
      if not (math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)):
        raise AssertionError(f"{trunk}: loss {a} against {b}")
    if worst > 2 * TRAIN_LR * SWEEP_PARITY_STEPS + 1e-6 or (
        share is not None and far > share * total):
      raise AssertionError(f"{trunk}: params {worst} apart at most, {far} "
                           f"of {total} beyond {TRAIN_PARAM_ATOL}")
    del vae, ref, step, step_cpu, s, s_cpu

  # -- 17.3 multi-seed: S lanes in one vmapped graph against solo runs
  S = len(SWEEP_SEEDS)
  vae = BetaVAE(beta=1.0, **get_networks("shapes3d", zdim=10))
  states = []
  for seed in SWEEP_SEEDS:
    vae.build(seed=seed, device=cuda)
    step = vae.make_step_fn(learning_rate=TRAIN_LR)
    states.append(vae.state)
  eval_fn = vae.make_eval_fn()
  saved = [st.rng.get_state() for st in states]
  reset_counts()
  fused = multiseed_device_dataset_steps(step, B, SWEEP_MS_STEPS,
                                         seeds=SWEEP_SEEDS)
  stacked, m = fused(stack_states(states), corpus)
  lanes = unstack_states(stacked)
  for st, g in zip(states, saved):
    st.rng.set_state(g)
  solo, m_solo = device_dataset_steps(step, B, SWEEP_MS_STEPS,
                                      seed=SWEEP_SEEDS[1])(states[1], corpus)
  torch.cuda.synchronize()
  log(f"multi-seed launches (cuDNN and cuBLAS, no kernel of this port): "
      f"{read_counts()}")
  lane_apart = max(float((lanes[1].params["vae"][k] - v).abs().max())
                   for k, v in solo.params["vae"].items())
  lane_far = sum(int(((lanes[1].params["vae"][k] - v).abs() >
                      SWEEP_LANE_ATOL).sum())
                 for k, v in solo.params["vae"].items())
  lanes_apart = max(float((lanes[0].params["vae"][k] - v).abs().max())
                    for k, v in lanes[1].params["vae"].items())
  log(f"multiseed_device_dataset_steps, S={S}, {SWEEP_MS_STEPS} steps: lane "
      f"1 against device_dataset_steps(seed={SWEEP_SEEDS[1]}) max |diff| "
      f"{lane_apart:.3g} (limit {SWEEP_LANE_ATOL}; {lane_far} elements "
      f"beyond it); losses lane 1 "
      f"{float(m['loss'][1]):.6f} / solo {float(m_solo['loss']):.6f}; lanes "
      f"0 and 1 {lanes_apart:.3g} apart; metrics {sorted(m)} of shape "
      f"{tuple(m['loss'].shape)}; capture {fused.capture_seconds or 0.0:.3f} s")
  if not lane_apart <= SWEEP_LANE_ATOL:
    raise AssertionError(f"lane 1 is {lane_apart} from its solo run")
  if not lanes_apart > 1e-3 or tuple(m["loss"].shape) != (S,):
    raise AssertionError(f"the lanes are {lanes_apart} apart, metrics "
                         f"{tuple(m['loss'].shape)}")
  for st, g in zip(states, saved):
    st.rng.set_state(g)
  before = [float(eval_fn(st, held)["loss"]) for st in states]
  fused_k = multiseed_device_dataset_steps(step, B, SWEEP_MS_K,
                                           seeds=SWEEP_SEEDS)
  t_first, (stacked, _) = sync_time(
      lambda: fused_k(stack_states(states), corpus))
  t_ms, (stacked, _) = sync_time(
      lambda: [fused_k(stacked, corpus) for _ in range(3)][-1])
  after = [float(eval_fn(st, held)["loss"]) for st in unstack_states(stacked)]
  solo_k = device_dataset_steps(step, B, SWEEP_MS_K, seed=SWEEP_SEEDS[0])
  t_solo_first, (s_solo, _) = sync_time(lambda: solo_k(states[0], corpus))
  t_solo, _ = sync_time(lambda: [solo_k(s_solo, corpus) for _ in range(3)])
  ms_lanes = 1e3 * t_ms / (3 * SWEEP_MS_K)
  ms_solo = 1e3 * t_solo / (3 * SWEEP_MS_K)
  log(f"multi-seed graph, S={S}, batch {B} a lane, k={SWEEP_MS_K}, 3 calls "
      f"after one warm-up: {ms_lanes:.3f} ms an S-lane step against "
      f"{S} x {ms_solo:.3f} = {S * ms_solo:.3f} ms of solo steps "
      f"({S * ms_solo / ms_lanes:.2f}x); first calls {t_first:.3f} s "
      f"(capture {fused_k.capture_seconds or 0.0:.3f} s) and {t_solo_first:.3f} s; "
      f"held-out loss ({SWEEP_HELD} test images) by lane: " + ", ".join(
          f"{a:.2f} -> {b:.2f}" for a, b in zip(before, after)) +
      f" after {4 * SWEEP_MS_K} steps; skipped "
      f"{stacked.skipped_updates.tolist()}")
  if not all(math.isfinite(b) and b < a for a, b in zip(before, after)):
    raise AssertionError(f"a lane's held-out loss did not fall: {before} -> "
                         f"{after}")
  del fused, fused_k, solo_k, stacked, lanes, solo, s_solo

  # -- 17.4 remat: the step under two policies against the plain one, the
  # gradients bitwise with cuDNN's deterministic algorithms; then each
  # graphed with the default algorithms, as the timed graphs of phase 7
  start = states[0]
  x0 = torch.from_numpy(xs[0]).to(cuda)
  e0 = torch.from_numpy(epss[0]).to(cuda)
  variants = (False,) + SWEEP_REMAT
  fns = [vae.make_step_fn(learning_rate=TRAIN_LR, remat=r,
                          keep_opt_states=True) for r in variants]
  torch.backends.cudnn.deterministic = True
  try:
    grads = [fn.value_and_grad(start, x0, eps=e0)[2]["vae"] for fn in fns]
  finally:
    torch.backends.cudnn.deterministic = False
  for remat, g in zip(variants[1:], grads[1:]):
    if not all(torch.equal(g[k], v) for k, v in grads[0].items()):
      raise AssertionError(f"remat={remat!r}: gradients differ from the "
                           "plain step's")
  rows = []
  for remat, fn in zip(variants, fns):
    fd = device_dataset_steps(fn, B, SWEEP_REMAT_K, seed=SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, (s_r, _) = sync_time(lambda: fd(start, corpus))
    peak = torch.cuda.max_memory_allocated() - base
    t, _ = sync_time(lambda: [fd(s_r, corpus) for _ in range(2)])
    rows.append((remat, peak, 1e3 * t / (2 * SWEEP_REMAT_K)))
    del fd, s_r
  log(f"remat, graphed device_dataset_steps at batch {B}; gradients "
      "bitwise the plain step's (cuDNN deterministic): " + "; ".join(
          f"remat={r!r}: peak {p / 2 ** 20:.1f} MiB above the held memory "
          f"over the first call (warm-up, capture, {SWEEP_REMAT_K} steps), "
          f"{ms:.3f} ms a step" for r, p, ms in rows))
  del vae, states, start, fns

  # -- 17.5 the sweep: run_hydra over two models, fit, the Gym, ScoreBoard
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      f"sweep_path_{os.getpid()}")
  shutil.rmtree(root, ignore_errors=True)
  runs = os.path.join(root, "runs")
  board = ScoreBoard(os.path.join(root, "scores.db"))
  rendered = {"shapes3d": ds}
  points = []

  @run_hydra(output_dir=runs, config=dict(ds="shapes3d", vae="betavae",
                                          beta=SWEEP_BETA, zdim=10,
                                          batch_size=B,
                                          max_iter=SWEEP_FIT_STEPS,
                                          lr=TRAIN_LR))
  def sweep(cfg):
    t0 = time.perf_counter()
    data = rendered.get(cfg.ds) or get_dataset(cfg.ds)
    model = get_vae(cfg.vae)(beta=cfg.beta, **get_networks(
        cfg.ds, zdim=cfg.zdim)).build(seed=SEED, device=cuda)
    tr = model.fit(data.create_dataset("train", batch_size=cfg.batch_size,
                                       epochs=-1, prefetch=2, to_device=cuda),
                   max_iter=cfg.max_iter, learning_rate=cfg.lr,
                   steps_per_call=SWEEP_FIT_K, logdir=cfg.output_dir,
                   logging_interval=1e9, verbose=False)
    gym = DisentanglementGym(dataset=data, model=model)
    gym.run_model(n_samples=SWEEP_GYM_ROWS, partition="test")
    scores = gym.write_report(scores=("mig", "sap", "dci"))
    numbers = {k: float(v) for k, v in scores.items()
               if isinstance(v, (int, float))}
    board.write("sweep", unique=["vae", "ds"], vae=cfg.vae, ds=cfg.ds,
                steps=int(model.state.step), **numbers)
    points.append((cfg.vae, cfg.output_dir, int(model.state.step),
                   int(model.state.skipped_updates), numbers,
                   sorted(k for k in scores if k.endswith("_error")),
                   tr.total_time, time.perf_counter() - t0))
    return numbers

  t0 = time.perf_counter()
  sweep(["vae=betavae,betatcvae", "-j1"])
  t_sweep = time.perf_counter() - t0
  for name, out_dir, steps, skipped, numbers, errors, t_fit, t_point in points:
    log(f"sweep point vae={name}: {steps} steps ({skipped} skipped) in "
        f"{t_fit:.2f} s of fit, {t_point:.2f} s in all; " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(numbers.items())) +
        f"; output {os.path.relpath(out_dir, root)}")
    if errors or steps != SWEEP_FIT_STEPS or skipped or not all(
        math.isfinite(v) for v in numbers.values()):
      raise AssertionError(f"sweep point {name}: errors {errors}, steps "
                           f"{steps}, skipped {skipped}, scores {numbers}")
  rows = ScoreBoard(os.path.join(root, "scores.db")).select("sweep",
                                                             order_by="vae")
  dirs = sorted(d for d in os.listdir(runs)
                if os.path.isdir(os.path.join(runs, d)))
  want_dirs = sorted(os.path.basename(get_output_dir(runs, {"vae": v}))
                     for v in ("betavae", "betatcvae"))
  log(f"run_hydra vae=betavae,betatcvae -j1: {t_sweep:.2f} s; ScoreBoard "
      f"rows {[(r['vae'], round(r['mig'], 4)) for r in rows]}; output "
      f"directories {dirs}")
  if [r["vae"] for r in rows] != ["betatcvae", "betavae"] or \
      dirs != want_dirs:
    raise AssertionError(f"rows {rows}, directories {dirs} (want "
                         f"{want_dirs})")
  try:
    sweep(["vae=betavae,betatcvae", "-j2"])
  except ValueError as e:
    log(f"run_hydra -j2 after CUDA started: refused ({e})")
  else:
    raise AssertionError("run_hydra -j2 forked beside the card's context")
  shutil.rmtree(root, ignore_errors=True)
  log(smi)


def multiseed_profile(argv) -> int:
  """``python3 chip_smoke.py --multiseed-profile [LANES [K]]``: where a
  multi-seed training step's time goes on the card, none of the phases:
  the graphed step of ``multiseed_device_dataset_steps`` (LANES lanes, 4
  by default, of the full-width Shapes3D beta-VAE at batch 64 a lane)
  beside the solo ``device_dataset_steps`` step, each timed over 3 calls
  of K steps (100) after a warm-up call and profiled by kernel with
  ``torch.profiler``, with cuDNN's heuristics and with
  ``torch.backends.cudnn.benchmark``.  TF32 off."""
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.fuel import Shapes3D
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import (device_dataset_steps,
                                       multiseed_device_dataset_steps,
                                       stack_states)

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card visible", file=sys.stderr)
    return 2
  lanes, k = (int(a) for a in (list(argv) + ["4", "100"][len(argv):])[:2])
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip()
  cuda = torch.device("cuda", 0)
  images = Shapes3D().numpy("train", inc_labels=False)
  corpus = torch.from_numpy((images * 255).astype(np.uint8)).to(cuda)
  seeds = list(range(lanes))
  vae = BetaVAE(beta=1.0, **get_networks("shapes3d", zdim=10))
  states = []
  for seed in seeds:
    vae.build(seed=seed, device=cuda)
    step = vae.make_step_fn(learning_rate=TRAIN_LR)
    states.append(vae.state)

  def timed(fused, state):
    state, _ = fused(state, corpus)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
      state, _ = fused(state, corpus)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (3 * k), state

  def kernels(fused, state, top=8):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fused(state, corpus)
      torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / k)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows[:top]

  for bench in (False, True):
    torch.backends.cudnn.benchmark = bench
    fused = multiseed_device_dataset_steps(step, TRAIN_BATCH, k, seeds=seeds)
    solo = device_dataset_steps(step, TRAIN_BATCH, k, seed=0)
    ms_lanes, stacked = timed(fused, stack_states(states))
    ms_solo, s_solo = timed(solo, states[0])
    log(f"cudnn.benchmark={bench}: S={lanes} lanes {ms_lanes:.3f} ms a step, "
        f"solo {ms_solo:.3f} ms ({lanes * ms_solo / ms_lanes:.2f}x the "
        f"throughput of {lanes} solo runs); {smi}")
    for name, fn, state in (("lanes", fused, stacked), ("solo", solo, s_solo)):
      total, top = kernels(fn, state)
      log(f"  {name}: {total:.3f} ms of kernels a step; " + "; ".join(
          f"{key[:70]} {ms:.3f}" for key, ms in top))
  return 0


def trunk_conditioning(argv) -> int:
  """``python3 chip_smoke.py --trunk-conditioning [STEPS]`` (on the CPU):
  how far float32 rounding moves each trunk's training, the reason phase
  17 holds the Locatello trunk's gradients step by step.  The BetaVAE on
  ``get_networks('shapes3d')`` (ELU) and on ``get_networks('locatello',
  n_channels=3)`` (ReLU) at batch 64 on Shapes3D images, in float32 and in
  float64 from the same weights, batches and noise: the first gradient
  and the params after STEPS (3) Adam steps.  A ReLU whose pre-activation
  lies near 0 takes the other gate where its sum is rounded otherwise, so
  its unit's gradients move by far more than the rounding; an ELU has no
  gate."""
  import numpy as np
  import torch
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.fuel import Shapes3D
  from odin_tpu_torch.networks import get_networks

  steps = int(argv[0]) if argv else 3
  images = Shapes3D(n_samples=512).numpy("train", inc_labels=False)
  rs = np.random.RandomState(SEED)
  idx = rs.randint(0, len(images), (steps, TRAIN_BATCH))
  xs = (images[idx] * 255).astype(np.uint8).astype(np.float32) / 255
  epss = rs.randn(steps, TRAIN_BATCH, 10).astype(np.float32)

  def run(trunk, dtype):
    kwargs = dict(n_channels=3) if trunk == "locatello" else {}
    vae = BetaVAE(beta=1.0, **get_networks(trunk, zdim=10, **kwargs)).build(
        seed=1, device="cpu")
    vae.core.to(dtype)
    vae.state = vae.state.replace(params={"vae": {
        k: v.to(dtype) for k, v in vae.state.params["vae"].items()}})
    step = vae.make_step_fn(learning_rate=TRAIN_LR)
    batches = [(torch.from_numpy(x).to(dtype), torch.from_numpy(e).to(dtype))
               for x, e in zip(xs, epss)]
    _, _, g = step.value_and_grad(vae.state, batches[0][0],
                                  eps=batches[0][1])
    s = vae.state
    for x, e in batches:
      s, _ = step(s, x, eps=e)
    return ({k: v.double() for k, v in g["vae"].items()},
            {k: v.double() for k, v in s.params["vae"].items()})

  for trunk in ("shapes3d", "locatello"):
    g32, p32 = run(trunk, torch.float32)
    g64, p64 = run(trunk, torch.float64)
    rel = max(float((g32[k] - w).abs().max() / w.abs().max())
              for k, w in g64.items())
    signs = sum(int(((g32[k] > 0) != (w > 0)).sum()) for k, w in g64.items())
    d = torch.cat([(p32[k] - w).abs().flatten() for k, w in p64.items()])
    log(f"{trunk}: first gradient, float32 against float64: max |diff| / "
        f"max |grad| of a tensor {rel:.3g}, {signs} signs apart; params "
        f"after {steps} Adam steps at {TRAIN_LR}: max |diff| "
        f"{float(d.max()):.3g}, {int((d > 1e-5).sum())} of {d.numel()} "
        f"beyond 1e-5")
  return 0


LAST_BATCH = 64
LAST_K = 100  # every recipe's fit: a CUDA graph of one step, 100 a call
LAST_RTOL = ZOO_RTOL  # card against CPU, of each term's largest magnitude
LAST_GRAD_REL = TRAIN_GRAD_REL  # gradients: 1e-4·max|CPU| of each tensor
# examples/topic_model.py's CONFIG and examples/grade_membership.py's
TOPIC_CONFIG = dict(n_docs=2000, n_words=200, n_topics=8, max_iter=2000,
                    lr=1e-3)
GOM_CONFIG = dict(n_sheets=2000, n_questions=12, n_answers=5, n_components=3,
                  noise=0.1, max_iter=600, lr=2e-2, warmup=200)
GOM_BATCH = 256
TOPIC_OTHER_STEPS = 100  # nonlinearLDA, ALDA and auxiliaryLDA
TOPIC_LABELLED = 0.1  # auxiliaryLDA: the share of labelled documents
# the recipes' figures: the card's medians over seeds held to the medians
# of the JAX package's own recipes on the CPU over 21 seeds
# (tests/recipe_seeds.py), with margins from the spread of those seeds'
# figures (PERF.md §6); one seed's figures spread widely in both
# packages, and a seed's initial weights differ between PyTorch versions
TOPIC_SEEDS = (1, 2, 3)  # the example's seed first
TOPIC_JAX = dict(perplexity=81.4197, topic_match=0.7362)
# the bounds that a median of 3 of JAX's own 21 seeds leaves 0.5 % beyond
TOPIC_PPL_RATIO = 1.05  # the median perplexity at most this times JAX's
TOPIC_MATCH_MARGIN = 0.07  # the median best-match cosine at most this below
GOM_SEEDS = tuple(range(21))  # the example's seed first
GOM_JAX = dict(accuracy=0.8812, purity=0.82)
# the bounds that a median of 21 of JAX's own seeds leaves 0.5 % beyond
GOM_ACC_MARGIN = 0.055  # median held-out accuracy at most this below
GOM_PURITY_MARGIN = 0.14  # median membership purity at most this below
PAIR_STEPS = 100  # the cycle-consistent VAE and the mixture of experts
PAIR_POOL = 2048  # rendered dSprites pairs or draws on the card
SEQ_T = 64  # frames a training segment
SEQ_STEPS = 100
SEQ_UTTERANCES = 64  # int16 utterances of 2-4 s a feature batch


def graphed_profile(torch, vae, batch, k=3, **options):
  """(kernels, device ms) a step of a CUDA graph of one step replayed `k`
  times on one batch, after one unprofiled call (``torch.profiler``)."""
  from torch.profiler import ProfilerActivity, profile

  from odin_tpu_torch.training import scan_steps

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


def card_against_cpu(torch, vae, ref, batch, step=700):
  """The model on the card (`vae`) against `ref`, the same class on the
  CPU, on `vae`'s params, `batch` and one set of noise drawn on the CPU
  (the ELBO terms and the training loss draw the same): (largest relative
  error of the ELBO terms, of the gradients of the training loss, the
  tensor of that gradient), each of a term's (tensor's) largest CPU
  magnitude."""
  from odin_tpu_torch.training import Noise

  cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
  to = lambda b, d: tuple(t.to(d) for t in b) if isinstance(b, tuple) \
      else b.to(d)
  params = {d: {p: {k: v.detach().to(d).clone() for k, v in part.items()}
                for p, part in vae.state.params.items()} for d in (cpu, cuda)}
  steps = {d: torch.tensor(step, dtype=torch.int32, device=d)
           for d in (cpu, cuda)}
  noise = Noise(torch.Generator().manual_seed(SEED))
  with torch.no_grad():
    l0, k0, _ = ref.elbo_components(params[cpu], to(batch, cpu), noise,
                                    steps[cpu])
    drawn = noise.drawn
    l1, k1, _ = vae.elbo_components(params[cuda], to(batch, cuda), Noise(
        eps=[t.to(cuda) for t in drawn]), steps[cuda])
  term_err = 0.0
  for key, v in {**l0, **k0}.items():
    c = {**l1, **k1}[key].float().cpu()
    term_err = max(term_err, float((c - v).abs().max()) /
                   max(float(v.abs().max()), 1e-30))
  grads = {}
  for model, d in ((ref, cpu), (vae, cuda)):
    leaves = {p: {k: v.clone().requires_grad_() for k, v in part.items()}
              for p, part in params[d].items()}
    loss, _ = model._vae_loss(leaves, to(batch, d),
                              Noise(eps=[t.to(d) for t in drawn]), steps[d],
                              dict(model.state.mutables))
    names = [(p, k) for p, part in leaves.items() for k in part]
    got = torch.autograd.grad(loss, [leaves[p][k] for p, k in names],
                              allow_unused=True)
    grads[d] = {n: (torch.zeros_like(leaves[n[0]][n[1]]) if g is None else g)
                for n, g in zip(names, got)}
  grad_err, worst = max((float((grads[cuda][n].cpu() - g).abs().max()) /
                         max(float(g.abs().max()), 1e-30), "/".join(n))
                        for n, g in grads[cpu].items())
  return term_err, grad_err, worst


def topic_figures(np, lda, ds):
  """(test perplexity, the recovered topics' mean best-match cosine to
  the true ones) of a trained LDA model on a ``SyntheticBoW``, as
  ``examples/topic_model.py`` computes them."""
  x_test, _ = ds.numpy("test")
  _, probs = lda.get_topics(top_k=10)
  probs = np.asarray(probs)
  sims = probs @ ds.topics.T
  sims = sims / (np.linalg.norm(probs, axis=1, keepdims=True) *
                 np.linalg.norm(ds.topics, axis=1)[None] + 1e-9)
  return float(lda.perplexity(x_test)), float(sims.max(axis=1).mean())


def topic_recipe(torch, np, device, seeds=(1,), max_iter=None, k=LAST_K):
  """``examples/topic_model.py`` on the port through ``run_hydra``, swept
  over the model's `seeds` (``seed=1,2,3``; the example's is 1):
  ``SyntheticBoW(n_docs=2000, n_words=200, n_topics=8)``, ``amortizedLDA``
  with its 128-128 encoder, ``fit`` of 2000 steps at batch 64 and lr 1e-3,
  `k` steps a call; then each point's test perplexity and the recovered
  topics' best-match cosine.  Returns (each point's figures, the first
  point's model, the dataset, the first point's trainer)."""
  import os
  import shutil

  from odin_tpu_torch.bay.vi import amortizedLDA
  from odin_tpu_torch.fuel import SyntheticBoW
  from odin_tpu_torch.training import run_hydra

  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      f"topic_recipe_{os.getpid()}")
  shutil.rmtree(root, ignore_errors=True)
  ds = SyntheticBoW(n_docs=TOPIC_CONFIG["n_docs"],
                    n_words=TOPIC_CONFIG["n_words"],
                    n_topics=TOPIC_CONFIG["n_topics"])
  out = []

  @run_hydra(output_dir=root, config=dict(TOPIC_CONFIG, seed=seeds[0]))
  def main(cfg):
    lda = amortizedLDA(n_words=cfg.n_words, n_topics=cfg.n_topics).build(
        seed=cfg.seed, device=device)
    train = ds.create_dataset("train", batch_size=LAST_BATCH, epochs=-1,
                              prefetch=2, to_device=device)
    tr = lda.fit(train, max_iter=cfg.max_iter, learning_rate=cfg.lr,
                 steps_per_call=k, logdir=cfg.output_dir,
                 logging_interval=1e9, verbose=False)
    ppl, match = topic_figures(np, lda, ds)
    if not out:
      out.append((lda, tr))
    return dict(perplexity=ppl, topic_match=match)

  argv = ["seed=" + ",".join(str(i) for i in seeds)]
  figures = main(argv + ([] if max_iter is None else
                         [f"max_iter={max_iter}"]))
  shutil.rmtree(root, ignore_errors=True)
  return (figures if len(seeds) > 1 else [figures]), out[0][0], ds, \
      out[0][1]


def gom_data(np):
  """``examples/grade_membership.py``'s sheets: planted profiles, 10 %
  noise, seed 0; (answers, members, n_train)."""
  cfg = GOM_CONFIG
  rng = np.random.RandomState(0)
  q, a, k = cfg["n_questions"], cfg["n_answers"], cfg["n_components"]
  profiles = (2 * np.arange(k)[:, None] + np.arange(q)[None, :]) % a
  members = rng.randint(0, k, size=cfg["n_sheets"])
  answers = profiles[members]
  noise = rng.rand(cfg["n_sheets"], q) < cfg["noise"]
  answers = np.where(noise, rng.randint(0, a, size=answers.shape), answers)
  return answers, members, int(0.9 * cfg["n_sheets"])


def gom_recipe(torch, np, device, seed=0, max_iter=None, k=LAST_K):
  """``examples/grade_membership.py`` on the port at `seed` (the example's
  is 0): the model at Q 12, A 5, K 3 and warm-up 200,
  ``fit_device_dataset`` of 600 steps at batch 256 and lr 2e-2, `k` a
  call; held-out accuracy and membership purity.  Returns (figures, the
  model, the seconds of its fit)."""
  from odin_tpu_torch.bay.mixed_membership import GradeMembershipModel

  cfg = GOM_CONFIG
  answers, members, n_train = gom_data(np)
  model = GradeMembershipModel(
      n_questions=cfg["n_questions"], n_answers=cfg["n_answers"],
      n_components=cfg["n_components"], warmup_steps=cfg["warmup"]).build(
          seed=seed, device=device)
  t0 = time.perf_counter()
  model.fit_device_dataset(answers[:n_train].astype("float32"),
                           n_steps=max_iter or cfg["max_iter"],
                           batch_size=GOM_BATCH, learning_rate=cfg["lr"],
                           steps_per_call=k, seed=seed, verbose=False)
  fit_s = time.perf_counter() - t0
  test = answers[n_train:]
  acc = float(np.mean(model.predict(test) == test))
  theta = model.transform(test)
  purity = 0.0
  for c in np.unique(theta.argmax(-1)):
    labels = members[n_train:][theta.argmax(-1) == c]
    if len(labels):
      purity += np.max(np.bincount(labels, minlength=cfg["n_components"]))
  return dict(accuracy=acc, purity=float(purity / len(test))), model, fit_s


def last_path(torch, np, reset_counts, read_counts, smi):
  """Phase 18: the last VAE classes on the card.  Six recipes, each
  ``fit`` at ``steps_per_call=100`` on the graphed step: the topic model
  of ``examples/topic_model.py`` through ``run_hydra`` (2000 steps) and
  nonlinearLDA, ALDA and auxiliaryLDA(n_labels=8, 10 % labelled) 100 steps
  each; Grade of Membership (``examples/grade_membership.py``,
  ``fit_device_dataset``); CycleConsistentVAE on 2,048 rendered dSprites
  pairs that share their shape; MoeVAE on the image and the 5 factor
  values of 2,048 dSprites draws, then ``cross_generate``; the sequential
  family on log-mels of 64 int16 utterances of 2-4 s from K1 (n_fft 512,
  40 mels), cut into segments of 64 frames.  Each class: its ELBO terms
  and loss gradients on the card against the CPU on the trained params,
  one batch and one set of noise; no update skipped; the held-out loss
  below its start; steps/s, a graphed step's kernels and device time,
  the capture time.  A failed check is logged and the phase goes on; it
  raises at the end with every failure.  Returns the K1 launches it
  made."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.fuel import dSprites
  from odin_tpu_torch.networks import Dense, SequentialNetwork, get_networks
  from odin_tpu_torch.ops.features import FeatureConfig, speech_features

  cuda = torch.device("cuda", 0)
  rows = []
  failures = []  # every check's, raised together at the end

  def fail(msg):
    log(f"check failed: {msg}")
    failures.append(msg)

  def batches(tensors, n, seed):
    """Batches of `n` rows drawn on the card from device tensors."""
    gen = torch.Generator(cuda).manual_seed(seed)
    size = tensors[0].shape[0]
    while True:
      i = torch.randint(0, size, (n,), generator=gen, device=cuda)
      out = tuple(t[i] for t in tensors)
      yield out[0] if len(out) == 1 else out

  def train_and_check(name, make, train, held, steps=None, trained=None):
    """Fit `make(cuda)`'s model on `train` for `steps` steps (or take
    `trained`: (a model a recipe trained, its steps/s, its capture s)),
    then its checks against `make(cpu)`."""
    t_class = time.perf_counter()
    if trained is None:
      vae = make(cuda)
      start = float(vae.make_eval_fn()(vae.state, held)["loss"])
      tr = vae.fit(train, max_iter=steps, steps_per_call=LAST_K,
                   logging_interval=1e9, verbose=False)
      capture = tr.capture_seconds or 0.0
      rate = steps / (tr.total_time - capture)
    else:  # its start is its fresh twin's (the same seed)
      fresh = make(cuda)
      start = float(fresh.make_eval_fn()(fresh.state, held)["loss"])
      vae, rate, capture = trained
      del fresh
    eval_fn = vae.make_eval_fn()
    end = float(eval_fn(vae.state, held)["loss"])
    skipped = int(vae.state.skipped_updates)
    if skipped or not end < start:
      fail(f"{name}: held-out loss {start:.6g} -> {end:.6g}, {skipped} "
           "updates skipped")
    term_err, grad_err, worst = card_against_cpu(torch, vae, make(
        torch.device("cpu")), held)
    if not (term_err <= LAST_RTOL and grad_err <= LAST_GRAD_REL):
      fail(f"{name}: card against CPU, ELBO terms {term_err:.3e} (limit "
           f"{LAST_RTOL}), gradients {grad_err:.3e} (limit {LAST_GRAD_REL})")
    kernels, step_ms = graphed_profile(torch, vae, held)
    rows.append((name, rate, step_ms, kernels, capture))
    log(f"{name}: held-out loss {start:.6g} -> {end:.6g}, skipped "
        f"{skipped}; card against CPU on the trained params: ELBO terms max "
        f"rel {term_err:.3e} (limit {LAST_RTOL}), gradients {grad_err:.3e} "
        f"({worst}; limit {LAST_GRAD_REL}); {rate:.1f} steps/s; a graphed "
        f"step {kernels:.0f} kernels, {step_ms:.3f} ms of device time; "
        f"capture {capture:.3f} s; {time.perf_counter() - t_class:.2f} s")
    return vae

  def medians(runs, keys):
    return {k: float(np.median([r[k] for r in runs])) for k in keys}

  # -- 18.1 the topic models
  t0 = time.perf_counter()
  runs, lda, bow, tr = topic_recipe(torch, np, cuda, seeds=TOPIC_SEEDS)
  capture = tr.capture_seconds or 0.0
  lda_rate = TOPIC_CONFIG["max_iter"] / (tr.total_time - capture)
  x_test = torch.from_numpy(bow.numpy("test")[0]).to(cuda)
  med = medians(runs, ("perplexity", "topic_match"))
  log(f"topic recipe (examples/topic_model.py through run_hydra, "
      f"{TOPIC_CONFIG['max_iter']} steps) at seeds {TOPIC_SEEDS}: test "
      f"perplexity " + ", ".join(f"{r['perplexity']:.2f}" for r in runs) +
      ", topic best-match cosine " + ", ".join(
          f"{r['topic_match']:.3f}" for r in runs) +
      f"; medians {med['perplexity']:.2f} and {med['topic_match']:.3f} "
      f"(JAX's on the CPU over 21 seeds {TOPIC_JAX['perplexity']} and "
      f"{TOPIC_JAX['topic_match']}, limits x{TOPIC_PPL_RATIO} and "
      f"-{TOPIC_MATCH_MARGIN}); {lda_rate:.1f} steps/s; "
      f"{time.perf_counter() - t0:.2f} s")
  if not (med["perplexity"] <= TOPIC_PPL_RATIO * TOPIC_JAX["perplexity"] and
          med["topic_match"] >= TOPIC_JAX["topic_match"] -
          TOPIC_MATCH_MARGIN):
    fail(f"the topic recipe's medians {med}, JAX's {TOPIC_JAX}")
  n_words, n_topics = TOPIC_CONFIG["n_words"], TOPIC_CONFIG["n_topics"]
  lda_make = lambda d: vi.amortizedLDA(n_words=n_words, n_topics=n_topics
                                       ).build(seed=TOPIC_SEEDS[0], device=d)
  train_and_check("amortizedLDA", lda_make, None, x_test[:LAST_BATCH],
                  trained=(lda, lda_rate, capture))
  x_train, y_train = (torch.from_numpy(a).to(cuda)
                      for a in bow.numpy("train"))
  for cls in ("nonlinearLDA", "ALDA"):
    make = lambda d, c=cls: getattr(vi, c)(n_words=n_words,
                                           n_topics=n_topics).build(device=d)
    train_and_check(cls, make, batches((x_train,), LAST_BATCH, SEED),
                    x_test[:LAST_BATCH], steps=TOPIC_OTHER_STEPS)
  n_lab = int(TOPIC_LABELLED * x_train.shape[0])
  mask = (torch.arange(x_train.shape[0], device=cuda) < n_lab).float()
  y_test = torch.from_numpy(bow.numpy("test")[1]).to(cuda)
  aux = train_and_check(
      "auxiliaryLDA", lambda d: vi.auxiliaryLDA(
          n_words=n_words, n_topics=n_topics, n_labels=n_topics).build(
              device=d), batches((x_train, y_train, mask), LAST_BATCH, SEED),
      (x_test[:LAST_BATCH], y_test[:LAST_BATCH],
       torch.ones(LAST_BATCH, device=cuda)), steps=TOPIC_OTHER_STEPS)
  del aux

  # -- 18.2 Grade of Membership, at 21 seeds, the example's first
  t0 = time.perf_counter()
  runs = []
  for seed in GOM_SEEDS:
    figures, model, seconds = gom_recipe(torch, np, cuda, seed=seed)
    runs.append(figures)
    if seed == GOM_SEEDS[0]:
      gom, fit_s = model, seconds
    del model
  answers, _, n_train = gom_data(np)
  gom_capture = gom.capture_seconds or 0.0
  gom_rate = GOM_CONFIG["max_iter"] / (fit_s - gom_capture)
  med = medians(runs, ("accuracy", "purity"))
  log(f"Grade of Membership recipe (examples/grade_membership.py) at seeds "
      f"{GOM_SEEDS[0]}-{GOM_SEEDS[-1]}: held-out accuracy " + ", ".join(
          f"{r['accuracy']:.3f}" for r in runs) + "; purity " +
      ", ".join(f"{r['purity']:.3f}" for r in runs) +
      f"; medians {med['accuracy']:.3f} and {med['purity']:.3f} (JAX's on "
      f"the CPU over 21 seeds {GOM_JAX['accuracy']} and {GOM_JAX['purity']}, "
      f"limits -{GOM_ACC_MARGIN} and -{GOM_PURITY_MARGIN}); "
      f"{time.perf_counter() - t0:.2f} s with the predictions")
  if not (med["accuracy"] >= GOM_JAX["accuracy"] - GOM_ACC_MARGIN and
          med["purity"] >= GOM_JAX["purity"] - GOM_PURITY_MARGIN):
    fail(f"the GoM recipe's medians {med}, JAX's {GOM_JAX}")
  del runs
  from odin_tpu_torch.bay.mixed_membership import GradeMembershipModel
  cfg = GOM_CONFIG
  gom_make = lambda d: GradeMembershipModel(
      n_questions=cfg["n_questions"], n_answers=cfg["n_answers"],
      n_components=cfg["n_components"], warmup_steps=cfg["warmup"]).build(
          seed=0, device=d)
  held_sheets = torch.from_numpy(answers[n_train:n_train + GOM_BATCH]).to(
      cuda, torch.float32)
  train_and_check("GradeMembershipModel", gom_make, None, held_sheets,
                  trained=(gom, gom_rate, gom_capture))

  # -- 18.3 the cycle-consistent VAE on pairs that share their shape
  t0 = time.perf_counter()
  x1, x2, _ = dsprites_pairs(np, "restricted", PAIR_POOL, SEED)
  hx1, hx2, _ = dsprites_pairs(np, "restricted", LAST_BATCH, SEED + 1)
  pool = (torch.from_numpy(x1).to(cuda), torch.from_numpy(x2).to(cuda))
  held = (torch.from_numpy(hx1).to(cuda), torch.from_numpy(hx2).to(cuda))
  log(f"{PAIR_POOL} dSprites pairs sharing shape and scale rendered in "
      f"{time.perf_counter() - t0:.2f} s")
  cyc = train_and_check(
      "CycleConsistentVAE", lambda d: vi.CycleConsistentVAE(
          **get_networks("dsprites", zdim=10)).build(seed=SEED, device=d),
      batches(pool, LAST_BATCH, SEED), held, steps=PAIR_STEPS)
  from odin_tpu_torch.training import Noise
  with torch.no_grad():
    _, kl, _ = cyc.elbo_components(cyc.state.params, held, Noise(
        torch.Generator(cuda).manual_seed(SEED)), cyc.state.step)
  cyc_term = kl["cycle_consistency"]
  log(f"CycleConsistentVAE cycle_consistency on the held-out pairs: mean "
      f"{float(cyc_term.mean()):.4f}, finite "
      f"{bool(torch.isfinite(cyc_term).all())}")
  if not bool(torch.isfinite(cyc_term).all()):
    fail("cycle_consistency is not finite")
  del cyc, pool

  # -- 18.4 the mixture of experts: image and factor values of one draw
  ds = dSprites(n_samples=1)
  sizes = np.asarray(ds.factor_sizes, np.float32)

  def draws(n, seed):
    f = ds._sample_factors(n, np.random.RandomState(seed))
    return (torch.from_numpy(ds.render(f)).to(cuda),
            torch.from_numpy((f / (sizes - 1)).astype(np.float32)).to(cuda))

  def moe_make(d):
    nets = get_networks("dsprites", zdim=10)
    mlp = lambda: SequentialNetwork((Dense(64, "relu"), Dense(64, "relu")))
    return vi.MoeVAE(
        encoders=[nets["encoder"], mlp()], decoders=[nets["decoder"], mlp()],
        observations=[nets["observation"],
                      RVconf((5,), "gaussian", projection=True,
                             name="factors")],
        latents=RVconf(10, "mvndiag", projection=True, name="latents"),
        input_shapes=[(64, 64, 1), (5,)]).build(seed=SEED, device=d)

  held = draws(LAST_BATCH, SEED + 1)
  moe = train_and_check("MoeVAE", moe_make,
                        batches(draws(PAIR_POOL, SEED), LAST_BATCH, SEED),
                        held, steps=PAIR_STEPS)
  px = moe.cross_generate(held[0], from_mod=0, to_mod=1)
  factors = px.mean()
  err = float((factors - held[1]).abs().mean())
  log(f"MoeVAE cross_generate image -> factors: {tuple(factors.shape)} on "
      f"{factors.device}, mean |factors - truth| {err:.4f} (0.25 would be "
      f"chance-level for uniform values), finite "
      f"{bool(torch.isfinite(factors).all())}")
  if tuple(factors.shape) != (LAST_BATCH, 5) or \
      not bool(torch.isfinite(factors).all()):
    fail(f"MoeVAE.cross_generate gave {tuple(factors.shape)} or "
         "non-finite values")
  del moe

  # -- 18.5 the sequential family on K1's log-mels: one feature batch
  config = FeatureConfig()
  n_samples = int(4.0 * config.sr)
  rs = np.random.RandomState(SEED)
  lengths = rs.randint(n_samples // 2, n_samples + 1, size=SEQ_UTTERANCES)
  pcm = np.zeros((SEQ_UTTERANCES, n_samples), np.int16)
  for j, n in enumerate(lengths):
    pcm[j, :n] = (rs.randn(n) * 0.1 * 32768.0).clip(-32768, 32767)
  reset_counts()
  feats = speech_features(pcm, config, lengths, device=cuda)["mspec"]
  counts = read_counts()
  torch.cuda.synchronize()
  want = speech_features(pcm, config, lengths, device="cpu")["mspec"]
  n_frames = [config.n_frames(int(n)) for n in lengths]
  db = max(float((feats[j, :n].cpu() - want[j, :n]).abs().max())
           for j, n in enumerate(n_frames))
  if counts.get("logmel") != 1 or counts.get("logmel_fft") != 1 or \
      db > LOGMEL_TOL_DB:
    fail(f"the sequence models' features: K1 launches {counts}, {db} dB "
         "from the CPU")
  segs = torch.cat([feats[j, :n - n % SEQ_T].reshape(-1, SEQ_T,
                                                     config.n_mels)
                    for j, n in enumerate(n_frames)])
  segs = (segs - segs.mean((0, 1))) / segs.std((0, 1))
  held, train = segs[:LAST_BATCH], segs[LAST_BATCH:]
  log(f"the sequence models' data: {SEQ_UTTERANCES} int16 utterances of "
      f"2-4 s, one K1 launch ({counts}), log-mels {db:.6f} dB from the CPU "
      f"(limit {LOGMEL_TOL_DB}); {segs.shape[0]} segments of {SEQ_T} x "
      f"{config.n_mels}, {LAST_BATCH} held out, standardised per band")
  for name, cls in (("VariationalRNN", vi.VariationalRNN),
                    ("SequentialVAE", vi.SequentialVAE),
                    ("SequentialAttentionVAE", vi.SequentialAttentionVAE)):
    make = lambda d, c=cls: c(input_shape=(SEQ_T, config.n_mels)).build(
        seed=SEED, device=d)
    train_and_check(name, make, batches((train,), LAST_BATCH, SEED), held,
                    steps=SEQ_STEPS)
  if failures:
    raise AssertionError(f"{len(failures)} check(s) failed: " +
                         "; ".join(failures))
  log(f"last-classes steps/s at fit(steps_per_call={LAST_K}) ({smi}): " +
      ", ".join(f"{n} {r:.1f}" for n, r, _, _, _ in rows) +
      "; a graphed step's device ms and kernels: " + ", ".join(
          f"{n} {ms:.3f} ms {k:.0f}" for n, _, ms, k, _ in rows) +
      "; capture s: " + ", ".join(f"{n} {c:.3f}" for n, _, _, _, c in rows))
  return 1


def last_rehearsal(argv) -> int:
  """``python3 chip_smoke.py --last-rehearsal [--steps 20] [--k 10]
  [--topic-steps 2000] [--gom-steps 600] [--pool 256]``: phase 18
  (``last_path``) on the CPU, its source and its helpers' recompiled with
  the card swapped for the CPU: the topic and GoM recipes at
  `--topic-steps` and `--gom-steps` (their full lengths by default, so
  that their figures can be read before a card run), every other class
  `--steps` steps at `--k` a call on pools of `--pool` rows; the K1 launch
  count reads one a feature batch and a graphed step's kernels 0.  A
  recipe cut below its length is not held to JAX's figures."""
  import argparse
  import inspect

  import numpy as np
  import torch

  ap = argparse.ArgumentParser(prog="chip_smoke.py --last-rehearsal")
  ap.add_argument("--steps", type=int, default=20)
  ap.add_argument("--k", type=int, default=10)
  ap.add_argument("--topic-steps", type=int,
                  default=TOPIC_CONFIG["max_iter"])
  ap.add_argument("--gom-steps", type=int, default=GOM_CONFIG["max_iter"])
  ap.add_argument("--pool", type=int, default=256)
  args = ap.parse_args(argv)
  torch.cuda.synchronize = lambda *a, **k: None
  scope = dict(globals())
  scope.update(
      LAST_K=args.k, TOPIC_OTHER_STEPS=args.steps, PAIR_STEPS=args.steps,
      SEQ_STEPS=args.steps, PAIR_POOL=args.pool,
      TOPIC_CONFIG=dict(TOPIC_CONFIG, max_iter=args.topic_steps),
      GOM_CONFIG=dict(GOM_CONFIG, max_iter=args.gom_steps))
  if args.topic_steps < TOPIC_CONFIG["max_iter"]:
    scope.update(TOPIC_PPL_RATIO=math.inf, TOPIC_MATCH_MARGIN=math.inf,
                 TOPIC_SEEDS=TOPIC_SEEDS[:1])
  if args.gom_steps < GOM_CONFIG["max_iter"]:
    scope.update(GOM_ACC_MARGIN=math.inf, GOM_PURITY_MARGIN=math.inf,
                 GOM_SEEDS=GOM_SEEDS[:2])
  for fn in (graphed_profile, card_against_cpu, topic_recipe, gom_recipe,
             last_path):
    src = inspect.getsource(fn).replace('torch.device("cuda", 0)',
                                        'torch.device("cpu")')
    exec(src, scope)
  counts = {"logmel": 1, "logmel_fft": 1, "logmel_fft_mixed": 0,
            "flash_attention": 0, "flash_attention_mma": 0}
  t0 = time.perf_counter()
  scope["last_path"](torch, np, lambda: None, lambda: dict(counts),
                     "CPU rehearsal, no card")
  log(f"phase 18 rehearsed on the CPU in {time.perf_counter() - t0:.2f} s")
  return 0


IMG_BATCH = 64
IMG_STEPS = 500  # each recipe's fit: 5 calls of IMG_K graphed steps
IMG_K = 100
IMG_VARIANT_STEPS = 100  # each variant's fit: one call
IMG_RTOL = ZOO_RTOL  # card against CPU, of each term's largest magnitude
# gradients, of each tensor's largest CPU magnitude: cuDNN's algorithms
# for mnist_networks' 5x5 convolutions put the card's float32 gradients
# 7.1e-4 to 1.4e-3 from float64 where the CPU's are 1.9e-6 and ATen's own
# CUDA convolutions 4.5e-7; the quantized logistic's float32 gradients are
# 7.5-11.6 % from float64 on either device, card and CPU 9.9e-6 to 2.6e-5
# apart (tools/image_grad_precision.py on an H100 80GB HBM3 at 700 W)
IMG_GRAD_REL = 2e-3
# the PixelCNN head's whole-image mixture: its responsibilities are exps
# of differences of float32 sums of 3,072 log-terms of about 8,600 nats,
# and the CPU's own float32 gradient lies 1.5e-2 (16 rows) and 8.4e-3 (64)
# from float64 (tools/image_grad_precision.py --nets pixelcnn)
IMG_MIX_GRAD_REL = 2e-2
IMG_CPU_ROWS = 16  # held-out rows of the card-against-CPU comparisons
# the files' splits (train, test): MNIST's and CIFAR's own; 64x64x3
# renders with 40 attributes for the CelebA-shaped variant
IMG_SPLITS = {"mnist": (60000, 10000), "cifar10": (50000, 10000),
              "celeba": (8192, 1024)}
IMG_CHUNK = 4096  # Shapes3D renders a chunk
IMG_MIX_K = 10  # the PixelCNN head's mixture components
IMG_LABELLED = 0.1  # the CelebA-shaped variant: labelled share of train
IMG_REWRITE_TOL = 1e-5  # a rewrite against its plain layer, of the largest
# output magnitude: float32 rounding of sums in another order


def images_root():
  import os
  return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "images_path")


def _shapes3d_renders(np, n, seed, size):
  """(n, size, size, 3) uint8 renders of the port's Shapes3D (area
  downsampled from 64 where size is 32) and their factor indices."""
  from odin_tpu_torch.fuel import Shapes3D
  ds = Shapes3D(n_samples=1)
  f = ds._sample_factors(n, np.random.RandomState(seed))
  x = np.empty((n, size, size, 3), np.uint8)
  for i in range(0, n, IMG_CHUNK):
    img = ds.render(f[i:i + IMG_CHUNK])
    if size != 64:
      r = 64 // size
      img = img.reshape(len(img), size, r, size, r, 3).mean((2, 4))
    x[i:i + IMG_CHUNK] = np.rint(img * 255.0).astype(np.uint8)
  return x, f.astype(np.int64), list(ds.factor_names)


def write_images(root, splits=None):
  """The data files of phase 19, written by a child process while the
  other phases run, in each dataset's ``.npz`` layout under
  ``root/datasets``: ``mnist.npz``, ``YDisentanglement`` renders at 28 x
  28 as uint8, labelled by the rotation factor in 10 classes;
  ``cifar10.npz``, the port's Shapes3D renders area-downsampled to 32 x 32
  x 3, labelled by object hue (10 classes); ``celeba.npz``, 64 x 64 x 3
  Shapes3D renders with 40 binary attributes (the one-hot floor, wall and
  object hues and shape, and scale above each of its first 6 steps).
  Needs no card."""
  import os
  import numpy as np
  from odin_tpu_torch.fuel import YDisentanglement
  splits = splits or IMG_SPLITS
  out = os.path.join(root, "datasets")
  os.makedirs(out, exist_ok=True)
  seconds = {}
  t0 = time.perf_counter()
  arrays = {}
  for part, n, seed in (("train", splits["mnist"][0], 1),
                        ("test", splits["mnist"][1], 2)):
    x, f = YDisentanglement(n_samples=n, image_size=28, seed=seed)._load(part)
    arrays[f"x_{part}"] = (x * 255).astype(np.uint8)
    arrays[f"y_{part}"] = (f[:, 0].astype(np.int64) * 10 // 16)
  np.savez(os.path.join(out, "mnist.npz"), **arrays)
  seconds["mnist"] = time.perf_counter() - t0
  for name, size in (("cifar10", 32), ("celeba", 64)):
    t0 = time.perf_counter()
    arrays = {}
    for part, n, seed in (("train", splits[name][0], 1),
                          ("test", splits[name][1], 2)):
      x, f, names = _shapes3d_renders(np, n, seed, size)
      col = lambda k: f[:, names.index(k)]
      if name == "cifar10":
        y = col("object_hue")
      else:
        y = np.concatenate(
            [np.eye(10, dtype=np.float32)[col("floor_hue")],
             np.eye(10, dtype=np.float32)[col("wall_hue")],
             np.eye(10, dtype=np.float32)[col("object_hue")],
             np.eye(4, dtype=np.float32)[col("shape")],
             (col("scale")[:, None] > np.arange(6)[None]).astype(
                 np.float32)], -1)
      arrays[f"x_{part}"], arrays[f"y_{part}"] = x, y
    np.savez(os.path.join(out, f"{name}.npz"), **arrays)
    seconds[name] = time.perf_counter() - t0
  with open(os.path.join(root, "written.json"), "w") as fh:
    json.dump(seconds, fh)


def start_images_writer():
  import os
  import shutil
  root = images_root()
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                           "--write-images", root])


def pack_mixture(torch, x):
  """A PixelCNN decoder's (B, H, W, C·3K) maps -> the 'mixqlogistic'
  head's flat params: the K logits (the first K maps of each channel
  averaged over the image), then the K location maps, then the K scale
  maps, each (K, H, W, C) in order."""
  b, h, w, ck = x.shape
  c = 3
  k = ck // (3 * c)
  g = x.reshape(b, h, w, 3 * k, c)
  logits = g[..., :k, :].mean(dim=(1, 2, 4))
  maps = lambda i: g[..., i * k:(i + 1) * k, :].permute(0, 3, 1, 2, 4
                                                          ).reshape(b, -1)
  return torch.cat([logits, maps(1), maps(2)], dim=-1)


def pixelcnn_networks(torch, n_components=IMG_MIX_K):
  """``cifar10_networks`` with a PixelCNN decoder (32 filters, 4 type-B
  layers) whose 3K maps a channel ``pack_mixture`` turns into the whole-
  image mixture of K quantized logistics ('mixqlogistic')."""
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.networks import Lambda, SequentialNetwork, get_networks
  from odin_tpu_torch.networks.resnets import PixelCNNDecoder
  nets = get_networks("cifar10")
  shape = nets["input_shape"]
  nets["decoder"] = SequentialNetwork((
      PixelCNNDecoder(shape, 32, 4, 3 * n_components),
      Lambda(lambda x: pack_mixture(torch, x))))
  nets["observation"] = RVconf(
      shape, "mixqlogistic", projection=False, name="image",
      kwargs=dict(n_components=n_components)).create_posterior()
  return nets


def images_path(torch, np, reset_counts, read_counts, smi, writer):
  """Phase 19: the natural-image VAEs on the card, at the published
  widths, on files ``write_images`` wrote in MNIST's, CIFAR-10's and
  CelebA's ``.npz`` layout and shape, loaded with ``get_dataset``.  The
  recipes ``BetaVAE(beta=1, **get_networks("mnist"))`` and ``...("cifar10")``
  (qlogistic likelihood) at batch 64 with ``get_optimizer_info``'s
  schedule: the ELBO terms and gradients on the card against the CPU (same
  weights, same noise, TF32 off), 500 steps of ``fit`` at
  ``steps_per_call=100`` (the held-out loss below its start, no update
  skipped), steps/s, a graphed step's kernels and device time.  The
  variants (cifar10 with ``resnet=True``, with a Gaussian likelihood, with
  the skip-generator decoder; a PixelCNN decoder with the 'mixqlogistic'
  head; ``celeba_networks(is_semi_supervised=True)``'s 40 Bernoulli
  attributes under ``MultitaskVAE``): the card against the CPU, then 100
  steps with a falling held-out loss.  Then the exact rewrites on the card
  at dSprites' widths: ``SpaceToDepthConv`` against ``Conv(k4, s2)`` and
  ``ConvTranspose(subpixel=True)`` against the plain one.  No kernel of
  the port is launched (JAX's image path has no Pallas kernel; the
  convolutions are cuDNN's).  A failed check is logged and the phase goes
  on; it raises at the end with every failure."""
  import os

  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.fuel import get_dataset
  from odin_tpu_torch.networks import (Conv, ConvTranspose, SpaceToDepthConv,
                                       get_networks, get_optimizer_info)

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  rows = []
  failures = []

  def fail(msg):
    log(f"check failed: {msg}")
    failures.append(msg)

  t0 = time.perf_counter()
  if writer is not None and writer.wait() != 0:
    raise AssertionError(f"the images writer failed ({writer.returncode})")
  waited = time.perf_counter() - t0
  root = images_root()
  with open(os.path.join(root, "written.json")) as fh:
    written = json.load(fh)
  data = {n: get_dataset(n, path=os.path.join(root, "datasets", f"{n}.npz"))
          for n in IMG_SPLITS}
  sizes = {n: {p: len(ds._load(p)[0]) for p in ("train", "valid", "test")}
           for n, ds in data.items()}
  log("images: files written by a child process while the other phases ran "
      "(" + ", ".join(f"{n} {s:.2f} s" for n, s in written.items()) +
      f"), waited {waited:.2f} s for it; loaded with get_dataset: " +
      "; ".join(f"{n} {data[n].shape} " + "/".join(
          str(v) for v in sz.values()) + " train/valid/test"
                for n, sz in sizes.items()))

  def held_of(name, n=IMG_BATCH, semi=False):
    x, y = data[name]._load("valid")
    x = torch.from_numpy(data[name].normalize255(x[:n])).to(cuda)
    if not semi:
      return x
    return (x, torch.from_numpy(np.asarray(y[:n], np.float32)).to(cuda),
            torch.ones(x.shape[0], device=cuda))

  def cpu_rows(batch):
    return tuple(b[:IMG_CPU_ROWS] for b in batch) \
        if isinstance(batch, tuple) else batch[:IMG_CPU_ROWS]

  def train_and_check(name, make, dname, steps, held, semi=False,
                      profile=False, grad_rel=IMG_GRAD_REL):
    """`make(cuda)`'s model against `make(cpu)` on its fresh weights, then
    `steps` steps of ``fit`` on `dname`'s train split at its schedule."""
    t_class = time.perf_counter()
    vae = make(cuda)
    term_err, grad_err, worst = card_against_cpu(
        torch, vae, make(cpu), cpu_rows(held), step=0)
    if not (term_err <= IMG_RTOL and grad_err <= grad_rel):
      fail(f"{name}: card against CPU, ELBO terms {term_err:.3e} (limit "
           f"{IMG_RTOL}), gradients {grad_err:.3e} (limit {grad_rel})")
    eval_fn = vae.make_eval_fn()
    start = float(eval_fn(vae.state, held)["loss"])
    kw = dict(label_percent=IMG_LABELLED, oversample_ratio=0.5) \
        if semi else {}
    train = data[dname].create_dataset("train", batch_size=IMG_BATCH,
                                       epochs=-1, prefetch=2, to_device=cuda,
                                       drop_remainder=True, **kw)
    lr = get_optimizer_info(dname, batch_size=IMG_BATCH)["learning_rate"]
    tr = vae.fit(train, max_iter=steps, steps_per_call=min(IMG_K, steps),
                 learning_rate=lr, logging_interval=1e9, verbose=False)
    end = float(eval_fn(vae.state, held)["loss"])
    skipped = int(vae.state.skipped_updates)
    if skipped or not end < start:
      fail(f"{name}: held-out loss {start:.6g} -> {end:.6g}, {skipped} "
           "updates skipped")
    capture = tr.capture_seconds or 0.0
    rate = steps / (tr.total_time - capture)
    kernels = step_ms = float("nan")
    if profile:
      kernels, step_ms = graphed_profile(torch, vae, held)
    rows.append((name, rate, step_ms, kernels, capture))
    log(f"{name}: card against CPU on the fresh weights ({IMG_CPU_ROWS} "
        f"held-out rows): ELBO terms max rel {term_err:.3e} (limit "
        f"{IMG_RTOL}), gradients {grad_err:.3e} ({worst}; limit "
        f"{grad_rel}); fit {steps} steps at lr {float(lr(0)):g}: "
        f"held-out loss {start:.6g} -> {end:.6g}, skipped {skipped}, "
        f"{rate:.1f} steps/s" + (
            f", a graphed step {kernels:.0f} kernels, {step_ms:.3f} ms of "
            f"device time" if profile else "") +
        f"; capture {capture:.3f} s; {time.perf_counter() - t_class:.2f} s")
    return vae

  reset_counts()
  # -- 19.1 the recipes, at the published widths
  for dname in ("mnist", "cifar10"):
    make = lambda d, n=dname: vi.BetaVAE(
        beta=1.0, **get_networks(n)).build(seed=SEED, device=d)
    train_and_check(f"BetaVAE {dname}", make, dname, IMG_STEPS,
                    held_of(dname), profile=True)
  # -- 19.2 the variants
  variants = [
      ("cifar10 resnet", lambda d: vi.BetaVAE(beta=1.0, **get_networks(
          "cifar10", resnet=True)).build(seed=SEED, device=d), "cifar10",
       False),
      ("cifar10 gaussian", lambda d: vi.BetaVAE(beta=1.0, **get_networks(
          "cifar10", distribution="gaussian")).build(seed=SEED, device=d),
       "cifar10", False),
      ("cifar10 skip_generator", lambda d: vi.BetaVAE(
          beta=1.0, **get_networks("cifar10", skip_generator=True)).build(
              seed=SEED, device=d), "cifar10", False),
      ("PixelCNN mixqlogistic", lambda d: vi.BetaVAE(
          beta=1.0, **pixelcnn_networks(torch)).build(seed=SEED, device=d),
       "cifar10", False),
      ("celeba semi MultitaskVAE", lambda d: vi.MultitaskVAE(
          **get_networks("celeba", is_semi_supervised=True)).build(
              seed=SEED, device=d), "celeba", True),
  ]
  for name, make, dname, semi in variants:
    train_and_check(name, make, dname, IMG_VARIANT_STEPS,
                    held_of(dname, semi=semi), semi=semi,
                    grad_rel=IMG_MIX_GRAD_REL if "PixelCNN" in name
                    else IMG_GRAD_REL)
  counts = read_counts()
  if any(counts.values()):
    fail(f"the image path launched kernels of the port: {counts}")

  # -- 19.3 the exact rewrites at dSprites' widths
  gen = torch.Generator().manual_seed(SEED)
  x = torch.rand(IMG_BATCH, 64, 64, 1, generator=gen).to(cuda)
  s2d, conv = SpaceToDepthConv(32, "elu"), Conv(32, 4, 2, "elu")
  s2d.build((64, 64, 1), gen)
  conv.build((64, 64, 1))
  with torch.no_grad():
    s2d.bias.copy_(torch.randn(32, generator=gen))
  conv.load_state_dict(s2d.state_dict())
  s2d, conv = s2d.to(cuda), conv.to(cuda)
  with torch.no_grad():
    want = conv(x)
    errs = {"SpaceToDepthConv 64x64x1 -> 32": float(
        (s2d(x) - want).abs().max()) / float(want.abs().max())}
    for shape, f in (((4, 4, 128), 64), ((8, 8, 64), 64), ((16, 16, 64), 32),
                     ((32, 32, 32), 32)):
      sub = ConvTranspose(f, 4, 2, "elu", subpixel=True)
      plain = ConvTranspose(f, 4, 2, "elu")
      sub.build(shape, gen)
      plain.build(shape)
      with torch.no_grad():
        sub.bias.copy_(torch.randn(f, generator=gen))
      plain.load_state_dict(sub.state_dict())
      sub, plain = sub.to(cuda), plain.to(cuda)
      h = torch.randn((IMG_BATCH,) + shape, generator=gen).to(cuda)
      want = plain(h)
      errs[f"subpixel ConvTranspose {'x'.join(map(str, shape))} -> {f}"] = \
          float((sub(h) - want).abs().max()) / float(want.abs().max())
  log("exact rewrites on the card (max |rewrite - plain| / max |plain|, "
      f"limit {IMG_REWRITE_TOL}): " + "; ".join(
          f"{k} {v:.3e}" for k, v in errs.items()))
  bad = {k: v for k, v in errs.items() if not v <= IMG_REWRITE_TOL}
  if bad:
    fail(f"rewrites differ from their plain layers: {bad}")
  if failures:
    raise AssertionError(f"{len(failures)} check(s) failed: " +
                         "; ".join(failures))
  log(f"images steps/s ({smi}): " + ", ".join(
      f"{n} {r:.1f}" for n, r, _, _, _ in rows) +
      "; a graphed step's device ms and kernels: " + ", ".join(
          f"{n} {ms:.3f} ms {k:.0f}" for n, _, ms, k, _ in rows
          if ms == ms) + "; capture s: " + ", ".join(
              f"{n} {c:.3f}" for n, _, _, _, c in rows) +
      f"; launches of the port's kernels: {counts}")


def images_rehearsal(argv) -> int:
  """``python3 chip_smoke.py --images-rehearsal [--steps 20] [--k 10]
  [--scale 0.02]``: phase 19 (``images_path``) on the CPU, its source and
  its helpers' recompiled with the card swapped for the CPU, on files of
  `--scale` times the phase's counts, each fit `--steps` steps at `--k` a
  call; a graphed step's kernels read 0."""
  import argparse
  import inspect

  import numpy as np
  import torch

  ap = argparse.ArgumentParser(prog="chip_smoke.py --images-rehearsal")
  ap.add_argument("--steps", type=int, default=20)
  ap.add_argument("--k", type=int, default=10)
  ap.add_argument("--scale", type=float, default=0.02)
  args = ap.parse_args(argv)
  torch.cuda.synchronize = lambda *a, **k: None
  splits = {n: tuple(max(int(v * args.scale), IMG_BATCH) for v in sp)
            for n, sp in IMG_SPLITS.items()}
  scope = dict(globals())
  scope.update(IMG_K=args.k, IMG_STEPS=args.steps,
               IMG_VARIANT_STEPS=args.steps)
  for fn in (graphed_profile, card_against_cpu, images_path):
    src = inspect.getsource(fn).replace('torch.device("cuda", 0)',
                                        'torch.device("cpu")')
    exec(src, scope)
  import os
  import shutil
  root = images_root()
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  t0 = time.perf_counter()
  write_images(root, splits)
  log(f"files of {splits} written in {time.perf_counter() - t0:.2f} s")
  t0 = time.perf_counter()
  scope["images_path"](torch, np, lambda: None, lambda: {},
                       "CPU rehearsal, no card", None)
  log(f"phase 19 rehearsed on the CPU in {time.perf_counter() - t0:.2f} s")
  shutil.rmtree(root, ignore_errors=True)
  return 0


GENE_BATCH = 64
GENE_STEPS = 500  # the cortex and pbmc runs: 5 calls of GENE_K graphed steps
GENE_K = 100
GENE_VARIANT_STEPS = 100  # each variant: one call
GENE_CELLS = 5000  # get_optimizer_info's n_samples for cortex and pbmc
GENE_SETS = {"cortex": (558, 7), "pbmc": (1000, 4)}  # genes, cell types
GENE_ATAC = dict(n_cells=2000, n_regions=300, n_topics=5)
GENE_LABELLED = 0.1  # pbmc's semi-supervised run: the labelled share
GENE_HELD = 256  # held-out cells of each run's held-out loss
GENE_CPU_ROWS = 64  # rows of the card-against-CPU comparisons
GENE_RTOL = ZOO_RTOL  # card against CPU, of each ELBO term's largest
# gradients, of each tensor's largest: no cuDNN on this path (an H100
# 80GB HBM3 at 700 W measured 3.0e-7 to 8.2e-6, PERF.md §6)
GENE_GRAD_REL = TRAIN_GRAD_REL
GENE_DIST_RTOL = 1e-5  # a family's statistics, card against CPU
GENE_DRAWS = 100_000  # each family's draws for its sample moments
GENE_SIGMAS = 5.0  # sample moments within this many standard errors


def genes_root():
  import os
  return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "genes_path")


def write_genes(np, root, cells=GENE_CELLS):
  """Cortex's and PBMC's ``.npz`` files (``x`` float32 counts, ``y`` int64
  cell types) under ``root/datasets``, drawn by ``SyntheticGenes`` at
  their gene and type counts."""
  import os
  from odin_tpu_torch.fuel import SyntheticGenes
  out = os.path.join(root, "datasets")
  os.makedirs(out, exist_ok=True)
  for i, (name, (genes, types)) in enumerate(GENE_SETS.items()):
    ds = SyntheticGenes(n_cells=cells, n_genes=genes, n_types=types,
                        seed=SEED + i)
    np.savez(os.path.join(out, f"{name}.npz"), x=ds._x, y=ds._y)


def gene_ssl_arrays(np, x, y, n_types, share=GENE_LABELLED, seed=SEED):
  """(x, one-hot y, mask) of a semi-supervised gene run: a seeded `share`
  of the cells labelled, the others' labels zeros, as JAX's
  ``_unpack_ssl`` reads a batch."""
  rs = np.random.RandomState(seed)
  mask = np.zeros(len(x), np.float32)
  mask[rs.permutation(len(x))[:int(round(share * len(x)))]] = 1.0
  onehot = np.eye(n_types, dtype=np.float32)[np.asarray(y, np.int64)]
  return (np.asarray(x, np.float32), onehot * mask[:, None], mask)


def zoo_families(torch, np):
  """name -> (build(device) -> distribution, value for its log_prob) of
  the families this slice ported (a ZeroInflated over NBDisp, Poisson
  and Bernoulli; ConditionalTensor and Batchwise), parameters drawn from
  one seed, batch (64, 8)."""
  from odin_tpu_torch.bay import distributions as D
  rs = np.random.RandomState(SEED)
  S = (64, 8)
  pos = lambda *s: (np.abs(rs.randn(*s)) + 0.3).astype(np.float32)
  real = lambda *s: rs.randn(*s).astype(np.float32)
  counts = rs.poisson(3.0, S).astype(np.float32)
  counts[rs.rand(*S) < 0.3] = 0
  tril = np.tril(real(64, 4, 4) * 0.4)
  tril[:, range(4), range(4)] = np.abs(tril[:, range(4), range(4)]) + 0.6
  low = pos(*S)
  y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 64)]
  specs = {
      "LogNormal": ("LogNormal", dict(loc=real(*S) * 0.3, scale=pos(*S) * .3),
                    pos(*S)),
      "Laplace": ("Laplace", dict(loc=real(*S), scale=pos(*S)), real(*S)),
      "Gamma": ("Gamma", dict(concentration=pos(*S) * 2, rate=pos(*S)),
                pos(*S)),
      "Beta": ("Beta", dict(concentration1=pos(*S) * 2,
                            concentration0=pos(*S) * 2),
               rs.uniform(0.05, 0.95, S).astype(np.float32)),
      "MultivariateNormalTriL": ("MultivariateNormalTriL", dict(
          loc=real(64, 4), scale_tril=tril), real(64, 4)),
      "NormalGamma": ("NormalGamma", dict(loc=real(*S), lam=pos(*S),
                                          alpha=pos(*S) * 3, beta=pos(*S)),
                      np.stack([real(*S), pos(*S)], -1)),
      "LogUniform": ("LogUniform", dict(low=low, high=low + pos(*S) * 3),
                     low + rs.uniform(0, 1, S).astype(np.float32)),
      "ContinuousBernoulli": ("ContinuousBernoulli", dict(logits=real(*S)),
                              rs.uniform(0, 1, S).astype(np.float32)),
      "RelaxedBernoulli": ("RelaxedBernoulli", dict(
          temperature=np.float32(0.5), logits=real(*S)),
          rs.uniform(0.01, 0.99, S).astype(np.float32)),
      "RelaxedOneHotCategorical": ("RelaxedOneHotCategorical", dict(
          temperature=np.float32(0.7), logits=real(64, 5)),
          rs.dirichlet(np.ones(5), 64).astype(np.float32)),
      "Poisson": ("Poisson", dict(log_rate=real(*S)), counts),
      "Binomial": ("Binomial", dict(total_count=np.float32(7.0),
                                    logits=real(*S)),
                   rs.randint(0, 8, S).astype(np.float32)),
      "Multinomial": ("Multinomial", dict(total_count=np.float32(9.0),
                                          logits=real(64, 4)),
                      rs.multinomial(9, [.2, .3, .1, .4], 64).astype(
                          np.float32)),
      "DirichletMultinomial": ("DirichletMultinomial", dict(
          total_count=np.float32(9.0), concentration=pos(64, 4) * 2),
          rs.multinomial(9, [.2, .3, .1, .4], 64).astype(np.float32)),
      "NegativeBinomial": ("NegativeBinomial", dict(total_count=pos(*S) * 3,
                                                    logits=real(*S)), counts),
      "NegativeBinomialDisp": ("NegativeBinomialDisp", dict(
          loc=pos(*S) * 3, disp=pos(*S) * 2), counts),
  }
  out = {}
  t = lambda a, d: torch.from_numpy(np.array(a)).to(d)
  for name, (cls, params, x) in specs.items():
    out[name] = ((lambda d, c=cls, p=params: getattr(D, c)(
        **{k: t(v, d) for k, v in p.items()})), x)
  gate = real(*S)
  nbd = specs["NegativeBinomialDisp"][1]
  out["ZeroInflated"] = ((lambda d: D.ZeroInflated(D.NegativeBinomialDisp(
      t(nbd["loc"], d), t(nbd["disp"], d)), logits=t(gate, d))), counts)
  mvn = dict(loc=real(64, 4), scale_diag=pos(64, 4))
  out["ConditionalTensor"] = ((lambda d: D.ConditionalTensor(
      D.MultivariateNormalDiag(t(mvn["loc"], d), t(mvn["scale_diag"], d)),
      t(y, d))), np.concatenate([real(64, 4), y], -1))
  out["Batchwise"] = ((lambda d: D.Batchwise([D.MultivariateNormalDiag(
      t(mvn["loc"][:24], d), t(mvn["scale_diag"][:24], d)),
      D.MultivariateNormalDiag(t(mvn["loc"][24:], d),
                               t(mvn["scale_diag"][24:], d))])), real(64, 4))
  return out


def zoo_kl_pairs(families):
  """(name, q, p) builders of every KL pair the slice registered, from the
  families' parameters (p a second family of the same kind: the first
  with its parameters rolled along the batch)."""
  from odin_tpu_torch.bay import distributions as D
  roll = lambda dist, fields: type(dist)(**{
      f: getattr(dist, f).roll(1, 0) for f in fields})
  pairs = {
      "LogNormal": ("loc", "scale"), "Gamma": ("concentration", "rate"),
      "Beta": ("concentration1", "concentration0"),
      "MultivariateNormalTriL": ("loc", "scale_tril"),
      "Poisson": ("log_rate",)}
  out = {}
  for name, fields in pairs.items():
    out[name] = (lambda d, n=name: families[n][0](d),
                 lambda d, n=name, f=fields: roll(families[n][0](d), f))
  tril = lambda d: families["MultivariateNormalTriL"][0](d)
  out["MVNDiag->TriL"] = (
      lambda d: D.MultivariateNormalDiag(tril(d).loc, torch_diag(tril(d))),
      tril)
  out["Normal->MVNDiag"] = (
      lambda d: D.Normal(tril(d).loc, torch_diag(tril(d))),
      lambda d: D.MultivariateNormalDiag(tril(d).loc.roll(1, 0),
                                         torch_diag(tril(d)).roll(1, 0)))
  ct = lambda d: families["ConditionalTensor"][0](d)
  out["ConditionalTensor"] = (ct, lambda d: D.ConditionalTensor(
      D.MultivariateNormalDiag(ct(d).distribution.loc.roll(1, 0),
                               ct(d).distribution.scale_diag),
      ct(d).conditional_tensor))
  bw = lambda d: families["Batchwise"][0](d)
  out["Batchwise"] = (bw, lambda d: D.MultivariateNormalDiag(
      bw(d).distributions[0].loc[0] * 0, bw(d).distributions[0].scale_diag[0]))
  return out


def torch_diag(tril):
  return tril.scale_tril.diagonal(dim1=-2, dim2=-1)


def zoo_on_card(torch, np, fail):
  """Every family of the slice on the card against the CPU (log_prob,
  mean, variance, entropy where defined, every registered KL), then its
  sample moments over GENE_DRAWS draws on the card against its analytic
  mean and variance.  Returns (worst relative error, its name, the number
  of moment checks)."""
  cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
  fams = zoo_families(torch, np)
  worst, where = 0.0, ""

  def compare(name, a, b, terms=None):
    """`a` (card) against `b` (CPU), of b's largest magnitude; `terms`,
    where given, the magnitude of the float32 terms each element is a
    difference of, whose rounding (8 ulps of them) it may keep too."""
    nonlocal worst, where
    a, b = a.detach().float().cpu(), b.detach().float()
    if a.shape != b.shape:
      fail(f"{name}: card shape {tuple(a.shape)}, CPU {tuple(b.shape)}")
      return
    if not (bool(torch.isfinite(a).all()) == bool(torch.isfinite(b).all())):
      fail(f"{name}: non-finite values on one device only")
      return
    ok = torch.isfinite(b)
    d = (a - b).abs()
    if terms is not None:
      d = (d - 8 * torch.finfo(torch.float32).eps * terms.float()).clamp(
          min=0)
    err = float(d[ok].max()) / max(float(b[ok].abs().max()),
                                   1e-30) if ok.any() else 0.0
    if err > worst:
      worst, where = err, name
    if not err <= GENE_DIST_RTOL:
      fail(f"{name}: card against CPU {err:.3e} (limit {GENE_DIST_RTOL})")

  for name, (make, x) in fams.items():
    dc, dg = make(cpu), make(cuda)
    xc = torch.from_numpy(np.array(x))
    compare(f"{name}.log_prob", dg.log_prob(xc.to(cuda)), dc.log_prob(xc))
    for stat in ("mean", "variance", "entropy"):
      try:
        want = getattr(dc, stat)()
      except NotImplementedError:
        continue
      terms = None
      if name == "ContinuousBernoulli" and stat == "mean":
        # JAX's formula: lam/(2 lam - 1) + 1/(2 atanh(1 - 2 lam)) outside
        # |lam - 1/2| < 1e-4, two terms of up to 2,500 that cancel to
        # about 1/2
        lam = dc.probs.double().clamp(1e-6, 1 - 1e-6)
        terms = (lam / (2 * lam - 1)).abs() + (
            1 / (2 * torch.atanh(1 - 2 * lam))).abs()
      compare(f"{name}.{stat}", getattr(dg, stat)(), want, terms)
  for name, (q, p) in zoo_kl_pairs(fams).items():
    compare(f"KL {name}", q(cuda).kl_divergence(p(cuda)),
            q(cpu).kl_divergence(p(cpu)))
  # sample moments on the card
  gen = torch.Generator(device=cuda).manual_seed(SEED)
  n_moments = 0
  for name in ("LogNormal", "Laplace", "Gamma", "Beta",
               "MultivariateNormalTriL", "Poisson", "Binomial", "Multinomial",
               "NegativeBinomial", "NegativeBinomialDisp", "ZeroInflated",
               "DirichletMultinomial", "LogUniform", "ContinuousBernoulli",
               "NormalGamma", "RelaxedBernoulli",
               "RelaxedOneHotCategorical"):
    d = fams[name][0](cuda)
    s = d.sample((GENE_DRAWS,), generator=gen).double()
    if not bool(torch.isfinite(s).all()):
      fail(f"{name}: non-finite draws on the card")
      continue
    # the share of draws above 1/2 (of each argmax) is the relaxed
    # families' probability; the continuous Bernoulli draws the
    # Bernoulli's, as in JAX; the others' means (and variances) are
    # analytic
    if name == "RelaxedBernoulli":
      s, m = (s > 0.5).double(), torch.sigmoid(d.logits).double()
    elif name == "RelaxedOneHotCategorical":
      s = torch.nn.functional.one_hot(s.argmax(-1), s.shape[-1]).double()
      m = torch.softmax(d.logits, -1).double()
    elif name == "ContinuousBernoulli":
      m = d.probs.double()
    else:
      m = d.mean().double()
    two_points = name in ("RelaxedBernoulli", "RelaxedOneHotCategorical",
                          "ContinuousBernoulli")
    v = m * (1 - m) if two_points else d.variance().double() \
        if name not in ("DirichletMultinomial", "LogUniform",
                        "NormalGamma") else s.var(0)
    bad = (s.mean(0) - m).abs() > GENE_SIGMAS * torch.sqrt(v / GENE_DRAWS) \
        + 1e-12
    if not two_points and name not in ("DirichletMultinomial", "LogUniform",
                                       "NormalGamma"):
      m4 = ((s - s.mean(0)) ** 4).mean(0)
      se = torch.sqrt((m4 - s.var(0) ** 2).clamp(min=0) / GENE_DRAWS)
      bad |= (s.var(0) - v).abs() > GENE_SIGMAS * se + 1e-9
    n_moments += 1
    if bool(bad.any()):
      fail(f"{name}: {int(bad.sum())} sample moments beyond "
           f"{GENE_SIGMAS} standard errors over {GENE_DRAWS} draws")
  return worst, where, n_moments


def genes_card_against_cpu(torch, vae, ref, batch):
  """`vae` on the card against `ref` on the CPU on `vae`'s params, `batch`
  and the noise of one training-mode loss drawn on the CPU (dropout's
  uniforms included): (largest relative error of the ELBO terms, of the
  loss gradients, that gradient's tensor), each of the CPU value's
  largest magnitude."""
  from odin_tpu_torch.training import Noise

  cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
  to = lambda b, d: tuple(t.to(d) for t in b) if isinstance(b, tuple) \
      else b.to(d)
  params = {d: {p: {k: v.detach().to(d).clone() for k, v in part.items()}
                for p, part in vae.state.params.items()} for d in (cpu, cuda)}
  step = {d: torch.tensor(0, dtype=torch.int32, device=d) for d in (cpu,
                                                                    cuda)}
  noise = Noise(torch.Generator().manual_seed(SEED))
  with torch.no_grad():
    ref._vae_loss(params[cpu], to(batch, cpu), noise, step[cpu],
                  dict(ref.state.mutables))
  drawn = noise.drawn
  terms, grads = {}, {}
  for model, d in ((ref, cpu), (vae, cuda)):
    leaves = {p: {k: v.clone().requires_grad_() for k, v in part.items()}
              for p, part in params[d].items()}
    eps = Noise(eps=[t.to(d) for t in drawn])
    llk, kl, _ = model.elbo_components(leaves, to(batch, d), eps, step[d],
                                       training=True,
                                       mutables=dict(model.state.mutables))
    terms[d] = {k: v.detach().float().cpu() for k, v in {**llk,
                                                         **kl}.items()}
    loss, _ = model._vae_loss(leaves, to(batch, d),
                              Noise(eps=[t.to(d) for t in drawn]), step[d],
                              dict(model.state.mutables))
    names = [(p, k) for p, part in leaves.items() for k in part]
    got = torch.autograd.grad(loss, [leaves[p][k] for p, k in names],
                              allow_unused=True)
    grads[d] = {n: (torch.zeros_like(leaves[n[0]][n[1]]) if g is None
                    else g.cpu()) for n, g in zip(names, got)}
  term_err = max(float((terms[cuda][k] - v).abs().max()) /
                 max(float(v.abs().max()), 1e-30)
                 for k, v in terms[cpu].items())
  grad_err, worst = max((float((grads[cuda][n] - g).abs().max()) /
                         max(float(g.abs().max()), 1e-30), "/".join(n))
                        for n, g in grads[cpu].items())
  return term_err, grad_err, worst


def lgamma_float32_error(torch, vae, batch):
  """The largest relative error, against float64 on the card, of the
  float32 log-likelihood of `batch` under `vae`'s observation at its
  posterior mean (the ZINB's sums of lgamma over the genes)."""
  from odin_tpu_torch.bay.helpers import map_distributions
  with torch.no_grad():
    qz = vae.encode(batch)
    px = vae.decode(qz.mean())
    lp32 = px.log_prob(batch).double()
    px64 = map_distributions(lambda t: t.double(), px)
    lp64 = px64.log_prob(batch.double())
  return float((lp32 - lp64).abs().max()) / float(lp64.abs().max())


def genes_path(torch, np, reset_counts, read_counts, smi):
  """Phase 20: the distribution zoo and the gene-expression VAEs on the
  card.  Every family this slice ported on the card against the CPU and
  by its sample moments; Cortex's and PBMC's ``.npz`` files written from
  ``SyntheticGenes`` (558 genes and 7 types, 1000 and 4; 5,000 cells) and
  read with ``get_dataset``; ``VariationalAutoencoder(**get_networks(
  "cortex"))`` (zinbd genes, mvndiag latents) and ``M2VAE(**get_networks(
  "pbmc", is_semi_supervised=True))`` on (x, one-hot y, mask) batches, 10 %
  labelled, 500 steps each of ``fit`` at ``steps_per_call=100``, batch 64,
  ``get_optimizer_info``'s schedule; the cortex variants (6 other count
  likelihoods, mvntril and autoregressive latents, dropout 0.1 on the
  observation) and a zibernoulli run on ``SyntheticATAC``, 100 steps
  each.  Each run: the ELBO terms and gradients on the card against the
  CPU, the held-out loss below its start, no update skipped, steps/s; the
  cortex and pbmc steps profiled; the float32 ZINB log-likelihood against
  float64.  No kernel of the port is launched.  A failed check is logged
  and the phase goes on; it raises at the end with every failure."""
  import os
  import shutil

  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.fuel import DataPipeline, SyntheticATAC, get_dataset
  from odin_tpu_torch.networks import get_networks, get_optimizer_info
  from odin_tpu_torch.networks.image_networks import _gene_networks

  cuda = torch.device("cuda", 0)
  cpu = torch.device("cpu")
  rows, failures = [], []

  def fail(msg):
    log(f"check failed: {msg}")
    failures.append(msg)

  reset_counts()
  # -- 20.1 the distribution zoo on the card
  t0 = time.perf_counter()
  worst, where, n_moments = zoo_on_card(torch, np, fail)
  log(f"distribution zoo: 19 families on the card against the CPU "
      f"(log_prob, mean, variance, entropy, 9 KL pairs): worst {worst:.3e} "
      f"({where}; limit {GENE_DIST_RTOL}); {n_moments} families' sample "
      f"moments over {GENE_DRAWS} draws on the card within {GENE_SIGMAS} "
      f"standard errors; {time.perf_counter() - t0:.2f} s")

  # -- 20.2 the data
  root = genes_root()
  shutil.rmtree(root, ignore_errors=True)
  t0 = time.perf_counter()
  write_genes(np, root, GENE_CELLS)
  data = {n: get_dataset(n, path=os.path.join(root, "datasets", f"{n}.npz"))
          for n in GENE_SETS}
  atac = SyntheticATAC(seed=SEED, **GENE_ATAC)
  zeros = float((data["cortex"]._load("train")[0] == 0).mean())
  log(f"genes: cortex.npz and pbmc.npz of {GENE_CELLS} SyntheticGenes cells "
      f"each written and read with get_dataset, "
      + "; ".join(f"{n} {ds.shape} " + "/".join(
          str(len(ds._load(p)[0])) for p in ("train", "valid", "test"))
          for n, ds in data.items()) +
      f" train/valid/test, {zeros:.1%} of cortex's counts zero; "
      f"SyntheticATAC {atac.shape}; {time.perf_counter() - t0:.2f} s")

  def held_of(ds, semi=False, n_types=0):
    x, y = ds._load("valid")
    x, y = x[:GENE_HELD], y[:GENE_HELD]
    if not semi:
      return torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    return tuple(torch.from_numpy(a).to(cuda) for a in gene_ssl_arrays(
        np, x, y, n_types, share=1.0))

  def rows_of(batch):
    return tuple(b[:GENE_CPU_ROWS] for b in batch) \
        if isinstance(batch, tuple) else batch[:GENE_CPU_ROWS]

  def run(name, make, train, held, steps, lr, profile=False, lgamma=False):
    t_run = time.perf_counter()
    vae = make(cuda)
    term_err, grad_err, worst = genes_card_against_cpu(
        torch, vae, make(cpu), rows_of(held))
    if not (term_err <= GENE_RTOL and grad_err <= GENE_GRAD_REL):
      fail(f"{name}: card against CPU, ELBO terms {term_err:.3e} (limit "
           f"{GENE_RTOL}), gradients {grad_err:.3e} (limit {GENE_GRAD_REL})")
    extra = ""
    if lgamma:
      err = lgamma_float32_error(torch, vae, held)
      extra = f"; float32 log-likelihood against float64 {err:.3e}"
    eval_fn = vae.make_eval_fn()
    start = float(eval_fn(vae.state, held)["loss"])
    tr = vae.fit(train, max_iter=steps, steps_per_call=min(GENE_K, steps),
                 learning_rate=lr, logging_interval=1e9, verbose=False)
    end = float(eval_fn(vae.state, held)["loss"])
    skipped = int(vae.state.skipped_updates)
    if skipped or not end < start:
      fail(f"{name}: held-out loss {start:.6g} -> {end:.6g}, {skipped} "
           "updates skipped")
    capture = tr.capture_seconds or 0.0
    rate = steps / (tr.total_time - capture)
    kernels = step_ms = float("nan")
    if profile:
      kernels, step_ms = graphed_profile(torch, vae, held, k=10)
    rows.append((name, rate, step_ms, kernels))
    log(f"{name}: card against CPU ({GENE_CPU_ROWS} held-out rows): ELBO "
        f"terms {term_err:.3e} (limit {GENE_RTOL}), gradients "
        f"{grad_err:.3e} ({worst}; limit {GENE_GRAD_REL}){extra}; fit "
        f"{steps} steps at lr {float(lr(0)):g}: held-out loss {start:.6g} "
        f"-> {end:.6g}, skipped {skipped}, {rate:.1f} steps/s" + (
            f", a graphed step {kernels:.0f} kernels, {step_ms:.3f} ms of "
            f"device time" if profile else "") +
        f"; capture {capture:.3f} s; {time.perf_counter() - t_run:.2f} s")

  def train_of(ds):
    return ds.create_dataset("train", batch_size=GENE_BATCH, epochs=-1,
                             prefetch=2, to_device=cuda, drop_remainder=True)

  lr = {n: get_optimizer_info(n, batch_size=GENE_BATCH)["learning_rate"]
        for n in GENE_SETS}
  # -- 20.3 cortex, unsupervised, at JAX's defaults
  cortex = lambda d, **kw: vi.VariationalAutoencoder(**get_networks(
      "cortex", **kw)).build(seed=SEED, device=d)
  run("cortex VAE zinbd", cortex, train_of(data["cortex"]),
      held_of(data["cortex"]), GENE_STEPS, lr["cortex"], profile=True,
      lgamma=True)
  # -- 20.4 pbmc, semi-supervised M2VAE on 10 % labelled cells
  x, y = data["pbmc"].numpy("train")
  ssl = gene_ssl_arrays(np, x, y, GENE_SETS["pbmc"][1])
  pipe = DataPipeline(ssl, batch_size=GENE_BATCH, shuffle=True, epochs=-1,
                      drop_remainder=True, seed=SEED, prefetch=2,
                      to_device=cuda)
  run("pbmc M2VAE semi", lambda d: vi.M2VAE(**get_networks(
      "pbmc", is_semi_supervised=True)).build(seed=SEED, device=d), pipe,
      held_of(data["pbmc"], semi=True, n_types=GENE_SETS["pbmc"][1]),
      GENE_STEPS, lr["pbmc"], profile=True)
  log(f"pbmc labelled cells: {int(ssl[2].sum())} of {len(ssl[2])} "
      f"({GENE_LABELLED:.0%})")

  # -- 20.5 the variants, 100 steps each
  def variant(obs=None, obs_kwargs=None, latents=None, observation=None,
              **kw):
    def make(d):
      nets = get_networks("cortex", **(dict(distribution=obs) if obs
                                       else {}), **kw)
      if obs_kwargs:
        nets["observation"] = nets["observation"].copy(kwargs=obs_kwargs)
      if latents:
        nets["latents"] = nets["latents"].copy(**latents)
      if observation:
        nets["observation"] = nets["observation"].copy(**observation)
      return vi.VariationalAutoencoder(**nets).build(seed=SEED, device=d)
    return make

  variants = [(f"cortex {o}", variant(o)) for o in (
      "zinb", "nb", "nbd", "poisson", "zipoisson")]
  variants += [
      ("cortex mixzinb K=3", variant("mixzinb", {"n_components": 3})),
      ("cortex mvntril latents", variant(qz="mvntril")),
      ("cortex autoregressive latents", variant(
          latents=dict(autoregressive=True))),
      ("cortex dropout 0.1", variant(observation=dict(dropout=0.1)))]
  for name, make in variants:
    run(name, make, train_of(data["cortex"]), held_of(data["cortex"]),
        GENE_VARIANT_STEPS, lr["cortex"])
  run("SyntheticATAC zibernoulli", lambda d: vi.VariationalAutoencoder(
      **_gene_networks(GENE_ATAC["n_regions"], GENE_ATAC["n_topics"],
                       distribution="zibernoulli")).build(seed=SEED,
                                                          device=d),
      train_of(atac), held_of(atac), GENE_VARIANT_STEPS, lr["cortex"])
  counts = read_counts()
  if any(counts.values()):
    fail(f"the gene path launched kernels of the port: {counts}")
  shutil.rmtree(root, ignore_errors=True)
  if failures:
    raise AssertionError(f"{len(failures)} check(s) failed: " +
                         "; ".join(failures))
  log(f"genes steps/s ({smi}): " + ", ".join(
      f"{n} {r:.1f}" for n, r, _, _ in rows) +
      "; a graphed step's device ms and kernels: " + ", ".join(
          f"{n} {ms:.3f} ms {k:.0f}" for n, _, ms, k in rows if ms == ms) +
      f"; launches of the port's kernels: {counts}")


def genes_rehearsal(argv) -> int:
  """``python3 chip_smoke.py --genes-rehearsal [--steps 20] [--k 10]
  [--cells 600] [--draws 4000]``: phase 20 (``genes_path``) on the CPU,
  its source and its helpers' recompiled with the card swapped for the
  CPU, each fit `--steps` steps at `--k` a call."""
  import argparse
  import inspect

  import numpy as np
  import torch

  ap = argparse.ArgumentParser(prog="chip_smoke.py --genes-rehearsal")
  ap.add_argument("--steps", type=int, default=20)
  ap.add_argument("--k", type=int, default=10)
  ap.add_argument("--cells", type=int, default=600)
  ap.add_argument("--draws", type=int, default=4000)
  args = ap.parse_args(argv)
  torch.cuda.synchronize = lambda *a, **k: None
  scope = dict(globals())
  scope.update(GENE_K=args.k, GENE_STEPS=args.steps,
               GENE_VARIANT_STEPS=args.steps, GENE_CELLS=args.cells,
               GENE_DRAWS=args.draws,
               GENE_ATAC=dict(GENE_ATAC, n_cells=args.cells))
  for fn in (graphed_profile, genes_card_against_cpu, zoo_on_card,
             genes_path):
    src = inspect.getsource(fn).replace('torch.device("cuda", 0)',
                                        'torch.device("cpu")').replace(
        "torch.Generator(device=cuda)", "torch.Generator()")
    exec(src, scope)
  t0 = time.perf_counter()
  scope["genes_path"](torch, np, lambda: None, lambda: {},
                      "CPU rehearsal, no card")
  log(f"phase 20 rehearsed on the CPU in {time.perf_counter() - t0:.2f} s")
  return 0


# -- phase 21: the x-vector speaker path -----------------------------------
XV_FEATURES = dict(n_mels=24, n_ceps=14)  # examples/voxceleb/recipe.py:78
XV_EMBED = 512  # XVectorNet's default (odin_tpu/networks/time_delay.py:118)
XV_LR, XV_WD = 1e-3, 1e-4  # recipe.py:85
XV_BATCH = 32  # recipe.py:31
XV_STEPS = 1200  # recipe.py:31's max_iter
XV_PLDA = dict(n_phi=16, n_iter=8)  # recipe.py:113-114
XV_TRIALS = 2000  # recipe.py:53
XV_EMBED_CHUNK = 256  # utterances an embedding call
# one step, the card against the CPU from the same weights and batch, each
# over the CPU value's largest magnitude.  The CPU's float32 lies from
# float64 at (tools/xvector_recipe.py on the CPU, phase 9's corpus, the
# recipe's first batch of 32 x 398 frames at full width): loss 5.75e-8,
# logits 4.96e-7, embeddings 4.44e-7, gradients 1.64e-4 (the largest over
# the 16 tensors); the limits are about 100x those:
XV_LOSS_TOL = 6e-6
XV_LOGITS_TOL = 5e-5
XV_EMBED_TOL = 5e-5
XV_GRAD_TOL = 1.6e-2
# the recipe learns: the PLDA EER on the held-out speakers at most 1.5x
# the port's CPU run of the recipe at a reduced scale, fixed before the
# first card run (tools/xvector_recipe.py --steps 300 --frames 100 on the
# same files: EER 0.3073, the loss 4.13 -> 3.42 over the first and last
# 50 steps; chance is 0.5)
XV_PLDA_EER_MAX = 0.461
# 21.2, each layer on the card against the CPU from the same weights:
# outputs within 1e-5 of their largest magnitude, gradients within 1e-4 of
# each tensor's largest (tests/torch_layer_common.py's limits)
XV_LAYER_TOL = 1e-5
XV_LAYER_GRAD_TOL = 1e-4
# but the recurrent layers' outputs, which cuDNN's RNN kernels compute on
# the card: the CPU's float32 lies 1.2e-7 to 4.9e-7 from float64 at
# 21.2's shapes (tools/xvector_recipe.py, "layers_fp64"; their gradients
# 2.8e-7 to 5.3e-7), and the limit is about 100x the largest, as the
# recipe's step's limits are (an H100's cuDNN RNNs lie up to 1.44e-5
# from the CPU)
XV_RNN_TOL = 5e-5
XV_RNN_LAYERS = ("LSTM", "LSTM(last)", "GRU", "SimpleRNN")
XV_DROP_SIGMAS = 5.0  # a dropped share within 5 binomial standard errors


def make_trials(np, labels, n_trials=XV_TRIALS, seed=0):
  """``examples/voxceleb/recipe.py``'s balanced trial pairs over utterance
  indices: (pairs, is-target)."""
  rng = np.random.RandomState(seed)
  n = len(labels)
  pairs, truth = [], []
  while len(pairs) < n_trials:
    i, j = rng.randint(0, n, 2)
    if i == j:
      continue
    pairs.append((i, j))
    truth.append(labels[i] == labels[j])
  return np.asarray(pairs), np.asarray(truth)


def xvector_loss(torch, net, params, x, y):
  """The recipe's loss: the mean cross-entropy of whole utterances."""
  logits = torch.func.functional_call(net, params, (x,))
  return -torch.mean(torch.log_softmax(logits, -1)[
      torch.arange(len(y), device=y.device), y])


def xvector_recipe(torch, np, raw, spk, device, steps=XV_STEPS,
                   batch_size=XV_BATCH, embedding_dim=XV_EMBED, frames=None,
                   seed=SEED):
  """``examples/voxceleb/recipe.py:76-126`` through the port's API on
  `device`: ``batch_speech_features(raw, FeatureConfig(n_mels=24,
  n_ceps=14), features=("mfcc_cmvn",))``, every utterance cut to the
  shortest one's frames (or `frames`) so that they stack as the recipe
  stacks them, ``XVectorNet(n_classes, embedding_dim)`` built from
  `seed`, the port's ``AdamW(1e-3, weight_decay=1e-4)`` on the
  cross-entropy of batches drawn by ``RandomState(1)``, the embeddings of
  every utterance (``return_embedding=True``), ``PLDA(n_phi=16,
  n_iter=8)`` on the first half of the speakers and ``make_trials`` on
  the other half: EER and minDCF.  Returns the results, the model and
  each stage's seconds."""
  from odin_tpu_torch.backend import compute_EER, compute_minDCF, det_curve
  from odin_tpu_torch.ml import PLDA
  from odin_tpu_torch.networks import XVectorNet
  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.preprocessing import batch_speech_features
  from odin_tpu_torch.training.core import AdamW

  cuda = torch.device(device).type == "cuda"
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  out = {}

  def stage(name, fn):
    sync()
    t = time.perf_counter()
    result = fn()
    sync()
    out[name + "_s"] = time.perf_counter() - t
    return result

  feats = stage("features", lambda: [f["mfcc_cmvn"] for f in
                                     batch_speech_features(
                                         raw, FeatureConfig(**XV_FEATURES),
                                         features=("mfcc_cmvn",),
                                         device=device)])
  n_frames = frames or min(len(f) for f in feats)
  X = torch.from_numpy(np.stack([f[:n_frames] for f in feats]).astype(
      np.float32)).to(device)
  y = torch.from_numpy(np.asarray(spk, np.int64)).to(device)
  n_spk = int(np.max(spk)) + 1
  net = XVectorNet(n_classes=n_spk, embedding_dim=embedding_dim)
  net.build((None, X.shape[-1]), torch.Generator().manual_seed(seed))
  init = {k: v.detach().clone() for k, v in net.named_parameters()}
  net.to(device)
  params = {"net": {k: v.detach() for k, v in net.named_parameters()}}
  opt = AdamW(XV_LR, weight_decay=XV_WD)
  opt_state = opt.init(params)
  r = np.random.RandomState(1)
  losses, marks, batches = [], [], []
  t0 = time.perf_counter()
  for _ in range(steps):
    idx = r.randint(0, len(X), batch_size)
    batches.append(idx)
    if cuda:
      marks.append(torch.cuda.Event(enable_timing=True))
      marks[-1].record()
    else:
      marks.append(time.perf_counter())
    ix = torch.from_numpy(idx).to(device)
    p = {k: v.requires_grad_(True) for k, v in params["net"].items()}
    loss = xvector_loss(torch, net, p, X[ix], y[ix])
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
      upd, opt_state = opt.update({"net": grads}, opt_state,
                                  {"net": {k: v.detach() for k, v in
                                           p.items()}})
      params = {"net": {k: (p[k].detach() + upd["net"][k])
                        for k in p}}
    losses.append(loss.detach())
  if cuda:
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
  else:
    marks.append(time.perf_counter())
  sync()
  out["train_s"] = time.perf_counter() - t0
  # each step's ms: CUDA events on the card, the host clock on the CPU
  out["step_ms"] = sorted(a.elapsed_time(b) if cuda else 1e3 * (b - a)
                          for a, b in zip(marks[:-1], marks[1:]))
  out["losses"] = torch.stack(losses).cpu().numpy() if losses else \
      np.zeros(0, np.float32)

  def embed():
    with torch.no_grad():
      return torch.cat([torch.func.functional_call(
          net, params["net"], (X[i:i + XV_EMBED_CHUNK],),
          {"return_embedding": True})
          for i in range(0, len(X), XV_EMBED_CHUNK)])

  vecs = stage("embed", embed)
  spk = np.asarray(spk)
  held = spk >= n_spk // 2
  n_phi = min(XV_PLDA["n_phi"], embedding_dim // 2)
  held_t = torch.from_numpy(held).to(device)
  plda = stage("plda_fit", lambda: PLDA(
      n_phi=n_phi, n_iter=XV_PLDA["n_iter"], device=device).fit(
          vecs[~held_t], spk[~held]))
  pairs, truth = make_trials(np, spk[held].astype(int))
  v = vecs[held_t]
  scores = stage("plda_score", lambda: plda.score_trials(
      v[torch.from_numpy(pairs[:, 0]).to(device)],
      v[torch.from_numpy(pairs[:, 1]).to(device)]))
  Pfa, Pmiss = det_curve(truth, scores)[:2]
  out.update(feats=feats, X=X, y=y, net=net, init=init,
             params=params["net"], batches=batches, vecs=vecs, plda=plda,
             pairs=pairs, truth=truth, scores=scores, frames=n_frames,
             eer=compute_EER(Pfa, Pmiss), mindcf=compute_minDCF(Pfa,
                                                                Pmiss)[0])
  return out


def xvector_one_step(torch, net, init, x, y, device, dtype=None):
  """One step of the recipe's loss at the weights `init` on (x, y) on
  `device` (in `dtype`): {loss, logits, embedding, grads}, as float64
  numpy."""
  import copy
  model = copy.deepcopy(net).to(device)
  if dtype is not None:
    model = model.to(dtype)
  p = {k: v.to(device=device, dtype=dtype or v.dtype).clone()
       .requires_grad_(True) for k, v in init.items()}
  x = x.to(device=device, dtype=dtype or x.dtype)
  y = y.to(device)
  logits = torch.func.functional_call(model, p, (x,))
  loss = -torch.mean(torch.log_softmax(logits, -1)[
      torch.arange(len(y), device=y.device), y])
  grads = torch.autograd.grad(loss, list(p.values()))
  with torch.no_grad():
    emb = torch.func.functional_call(model, p, (x,),
                                     {"return_embedding": True})
  host = lambda t: t.detach().double().cpu().numpy()
  return dict(loss=host(loss), logits=host(logits), embedding=host(emb),
              grads={k: host(g) for k, g in zip(p, grads)})


def xvector_apart(np, got, want):
  """{name: the largest |got - want| over want's largest magnitude} of two
  ``xvector_one_step`` results; 'grads' the largest over the tensors."""
  rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                        1e-30))
  out = {k: rel(got[k], want[k]) for k in ("loss", "logits", "embedding")}
  out["grads"] = max(rel(got["grads"][k], want["grads"][k])
                     for k in want["grads"])
  return out


def xvector_layers(torch, np, device, dtype=None):
  """21.2: each class of ``networks/time_delay.py``, ``util_layers.py`` and
  ``dropout.py`` at small shapes on `device` (in `dtype`) against the CPU
  in float32 from the same weights (outputs, and the input's and the
  parameters' gradients), ``BatchRenormalization``'s running statistics
  after three training calls, and each dropout's dropped share on
  `device` against its rate.  Returns {layer: (output error, gradient
  error)}, each over the CPU's largest magnitude, and the dropouts'
  shares."""
  import copy
  from odin_tpu_torch import networks as N
  from odin_tpu_torch.networks.base import collecting_updates

  rs = np.random.RandomState(SEED)
  seq, img, labels = (6, 40, 12), (4, 9, 8, 8), (6, 10)
  # name: (the layer, its inputs' shapes); built on the first input's
  # shape, a second one's given as build's third argument
  layers = {
      "TimeDelay": (lambda: N.TimeDelay(16), [seq]),
      "TimeDelay(irregular)": (lambda: N.TimeDelay(16, (-3, 0, 1)), [seq]),
      "TimeDelayDense": (lambda: N.TimeDelayDense(16), [seq]),
      "TimeDelayConv": (lambda: N.TimeDelayConv(16, 4, 2), [seq]),
      "TimeDelayConvTied": (lambda: N.TimeDelayConvTied(16), [seq]),
      "StatsPool": (lambda: N.StatsPool(), [seq]),
      "XVectorNet": (lambda: N.XVectorNet(8, 32), [seq]),
      "Identity": (lambda: N.Identity(), [seq]),
      "ExpandDims": (lambda: N.ExpandDims(1), [seq]),
      "Reduce": (lambda: N.Reduce("std", 1), [seq]),
      "Conv1DTranspose": (lambda: N.Conv1DTranspose(8, 3, 2, "elu"), [seq]),
      "BatchRenormalization": (lambda: N.BatchRenormalization(), [seq]),
      "ParallelNetwork": (lambda: N.ParallelNetwork(
          (N.Dense(5, "relu"), N.Dense(3))), [seq]),
      "PositionalEncoder": (lambda: N.PositionalEncoder(), [seq]),
      "SkipConnection": (lambda: N.SkipConnection(N.Dense(10, "tanh")),
                         [seq]),
      "ConditionalEmbedding": (lambda: N.ConditionalEmbedding(10, 8),
                               [labels]),
      "ConditionalProjection": (lambda: N.ConditionalProjection(8, "film"),
                                [seq, labels]),
      "LSTM": (lambda: N.LSTM(16), [seq]),
      "LSTM(last)": (lambda: N.LSTM(16, return_sequences=False), [seq]),
      "GRU": (lambda: N.GRU(16), [seq]),
      "SimpleRNN": (lambda: N.SimpleRNN(16), [seq]),
      "DepthToSpace": (lambda: N.DepthToSpace(2), [img]),
      "Resampling2D(nearest)": (lambda: N.Resampling2D(1.5), [img]),
      "Resampling2D(linear)": (lambda: N.Resampling2D(0.7, "linear"), [img]),
      "Resampling2D(cubic)": (lambda: N.Resampling2D(2.0, "cubic"), [img]),
  }
  errs = {}
  rel = lambda a, b: float((a.detach().cpu().double() - b.detach().double())
                           .abs().max() / max(float(b.detach().abs().max()),
                                              1e-30))
  for name, (make, shapes) in layers.items():
    ref = make()
    ref.build(shapes[0][1:], torch.Generator().manual_seed(SEED),
              *(s[1:] for s in shapes[1:]))
    mod = copy.deepcopy(ref).to(device=device, dtype=dtype)
    xs = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in shapes]
    outs, grads = [], []
    for m, dev, dt in ((mod, device, dtype), (ref, "cpu", None)):
      m.eval()
      xi = [x.to(device=dev, dtype=dt).requires_grad_(True) for x in xs]
      out = m(*xi)
      w = torch.from_numpy(np.random.RandomState(1).randn(*out.shape)
                           .astype(np.float32)).to(device=dev, dtype=dt)
      (out * w).sum().backward()
      outs.append(out)
      # a parameter the output does not use has no gradient (FiLM's
      # cond_proj, as in JAX): 0 on both sides
      grads.append([x.grad for x in xi] + [
          torch.zeros_like(p) if p.grad is None else p.grad
          for p in m.parameters()])
    errs[name] = (rel(*outs), max(rel(a, b) for a, b in zip(*grads)))
  # BatchRenormalization's running statistics after three training calls
  ref = N.BatchRenormalization()
  ref.build((12,))
  mod = copy.deepcopy(ref).to(device=device, dtype=dtype)
  for call in range(3):
    x = torch.from_numpy((rs.randn(64, 12) * 5 + call).astype(np.float32))
    for m, xi in ((mod, x.to(device=device, dtype=dtype)), (ref, x)):
      m.train()
      with collecting_updates() as upd:
        m(xi)
      for (owner, buf), v in upd.items():
        getattr(owner, buf).copy_(v.detach())
  errs["BatchRenormalization(stats)"] = (max(rel(mod.mean, ref.mean),
                                             rel(mod.var, ref.var)), 0.0)
  # the dropouts' dropped shares on the device: counts of 1000 thinned at
  # 0.2 always change, so DiscreteDropout's changed share is its rate; a
  # DropBlock of size 1 drops each pixel with its rate
  gen = torch.Generator(device=device).manual_seed(SEED)
  shares = {}
  for name, m, x, rate in (
      ("DiscreteDropout", N.DiscreteDropout(0.3, 0.2),
       torch.full((512, 1024), 1000.0, device=device), 0.3),
      ("DropBlock(1)", N.DropBlock(0.1, 1),
       torch.ones(16, 64, 64, 32, device=device), 0.1)):
    got = m.train()(x, rng=gen)
    share = float((got != x).float().mean() if name == "DiscreteDropout"
                  else (got == 0).float().mean())
    sd = math.sqrt(rate * (1 - rate) / x.numel())
    shares[name] = (share, rate, sd)
  blocks = N.DropBlock(0.1, 3).train()(torch.ones(16, 64, 64, 32,
                                                  device=device), rng=gen)
  shares["DropBlock(3)"] = (float((blocks == 0).float().mean()), 0.1, None)
  return errs, shares


def xvector_flops(net, n, frames):
  """Multiply-adds x 2 of a forward of `n` utterances of `frames` frames
  through ``net`` (the TDNN layers, then the Denses on the pooled
  statistics); a training step is about three times that."""
  per_frame = sum(layer.weight.numel() for layer in net.frame_layers())
  dense = sum(m.weight.numel() for m in (net.embedding_a, net.embedding_b,
                                         net.classifier))
  return 2.0 * n * (frames * per_frame + dense)


def xvector_path(torch, np, reset_counts, read_counts, smi):
  """Phase 21: the x-vector recipe on phase 9's wav files, one step and
  each layer on the card against the CPU (see the docstring); returns
  K1's launches on the path and what phase 22 reads (the raw utterances,
  their speakers and utterance numbers, the ``embedding_a`` vectors)."""
  import glob
  import os
  import re
  from torch.profiler import ProfilerActivity, profile

  from odin_tpu_torch.preprocessing.speech import read_wave_raw

  files = sorted(glob.glob(os.path.join(corpus_root(), "wav", "*.wav")))
  if len(files) != CORPUS_SPEAKERS * CORPUS_UTTERANCES:
    raise AssertionError(f"{len(files)} wav files of phase 9 left")
  spk = np.array([int(re.match(r"s(\d+)_", os.path.basename(f)).group(1))
                  for f in files])
  t0 = time.perf_counter()
  raw = [read_wave_raw(f)[0] for f in files]
  read_s = time.perf_counter() - t0

  # -- 21.1 the recipe on the card: the main path
  reset_counts()
  r = xvector_recipe(torch, np, raw, spk, "cuda")
  counts = read_counts()
  n_batches = -(-len(files) // CORPUS_BATCH)
  log(f"x-vector path launches (batch_speech_features of {len(files)} "
      f"files, {n_batches} batches of {CORPUS_BATCH}; the network runs "
      f"cuDNN, cuBLAS and torch's own kernels): {counts}")
  if counts["logmel"] != n_batches or counts["logmel_fft"] != n_batches:
    raise AssertionError(f"the x-vector path launched K1 {counts}, not "
                         f"once a batch ({n_batches})")
  losses = r["losses"]
  if not np.isfinite(losses).all():
    raise AssertionError(f"non-finite losses at steps "
                         f"{np.flatnonzero(~np.isfinite(losses))[:10]}")
  k = max(1, min(50, len(losses) // 4))  # steps averaged at each end
  first, last = float(losses[:k].mean()), float(losses[-k:].mean())
  net, X, y = r["net"], r["X"], r["y"]
  n_spk = int(spk.max()) + 1
  flops = 3 * xvector_flops(net, len(r["batches"][0]), r["frames"])
  step_ms = r["step_ms"][len(r["step_ms"]) // 2]
  # kernels a step: three more steps from the trained weights, profiled
  p = {k: v.detach().clone() for k, v in r["params"].items()}
  ix = torch.from_numpy(r["batches"][0]).to(X.device)

  def step():
    q = {k: v.requires_grad_(True) for k, v in p.items()}
    loss = xvector_loss(torch, net, q, X[ix], y[ix])
    return torch.autograd.grad(loss, list(q.values()))

  step()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
      step()
    torch.cuda.synchronize()
  busy_ms, n_kernels = device_busy(torch, prof)
  top = sorted(((e.key, e.self_device_time_total / 1e3 / 3)
                for e in prof.key_averages()
                if e.self_device_time_total > 0), key=lambda t: -t[1])[:6]
  log("x-vector step's kernels by device time (ms a step): " + "; ".join(
      f"{key[:70]} {t:.3f}" for key, t in top))
  log(f"x-vector recipe on the card: {len(files)} utterances of {n_spk} "
      f"speakers cut to {r['frames']} frames of {X.shape[-1]} mfcc_cmvn "
      f"dims; read {read_s:.3f} s; features {r['features_s']:.3f} s; "
      f"XVectorNet(n_classes={n_spk}, embedding_dim={net.embedding_dim}), "
      f"{sum(v.numel() for v in r['params'].values())} parameters; "
      f"{len(losses)} AdamW steps at batch {len(r['batches'][0])}: "
      f"{r['train_s']:.3f} s, "
      f"median {step_ms:.3f} ms a step (CUDA events, p90 "
      f"{r['step_ms'][int(0.9 * len(r['step_ms']))]:.3f}), "
      f"{n_kernels / 3:.1f} kernels and {busy_ms / 3:.3f} ms of device time "
      f"a step (torch.profiler), {flops / 1e9:.2f} GFLOP a step, "
      f"{flops / (step_ms * 1e-3) / FP32_PEAK_FLOPS * 100:.2f} % of fp32 "
      f"peak; loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} "
      f"(mean of the first {k} {first:.4f}, of the last {k} {last:.4f}); "
      f"embeddings {r['embed_s']:.3f} s, PLDA fit {r['plda_fit_s']:.3f} s, "
      f"{XV_TRIALS} trials scored {r['plda_score_s']:.3f} s; {smi}")
  log(f"x-vector results on the card: PLDA EER {r['eer']:.6f}, minDCF "
      f"{r['mindcf']:.6f} ({int(r['truth'].sum())} target / "
      f"{int((~r['truth']).sum())} non-target trials on speakers "
      f"{n_spk // 2}-{n_spk - 1}; "
      f"limit {XV_PLDA_EER_MAX})")
  if not last < first:
    raise AssertionError(f"the loss did not fall: {first} -> {last}")
  if not r["eer"] <= XV_PLDA_EER_MAX:
    raise AssertionError(f"PLDA EER {r['eer']} above {XV_PLDA_EER_MAX}")
  vecs = r["vecs"]
  if tuple(vecs.shape) != (len(files), net.embedding_dim) or \
      not bool(torch.isfinite(vecs).all()):
    raise AssertionError(f"embeddings {tuple(vecs.shape)}, finite "
                         f"{bool(torch.isfinite(vecs).all())}")

  # -- the card against the CPU, one step from the initial weights on the
  # recipe's first batch
  xb, yb = X[ix].cpu(), y[ix].cpu()
  got = xvector_one_step(torch, net, r["init"], xb, yb, "cuda")
  want = xvector_one_step(torch, net, r["init"], xb, yb, "cpu")
  apart = xvector_apart(np, got, want)
  limits = dict(loss=XV_LOSS_TOL, logits=XV_LOGITS_TOL,
                embedding=XV_EMBED_TOL, grads=XV_GRAD_TOL)
  log("one step, card against CPU (of the CPU's largest magnitude): " +
      ", ".join(f"{k} {v:.3g} (limit {limits[k]})" for k, v in
                apart.items()))
  bad = {k: v for k, v in apart.items() if not v <= limits[k]}
  if bad:
    raise AssertionError(f"the card differs from the CPU: {bad}")

  # -- 21.2 each layer on the card against the CPU
  t0 = time.perf_counter()
  errs, shares = xvector_layers(torch, np, "cuda")
  log("layers on the card against the CPU (output, gradient errors of the "
      "largest magnitude): " + ", ".join(
          f"{k} {a:.3g}/{b:.3g}" for k, (a, b) in errs.items()) +
      f" ({time.perf_counter() - t0:.3f} s)")
  limit = lambda k: (XV_RNN_TOL if k in XV_RNN_LAYERS else XV_LAYER_TOL,
                     XV_LAYER_GRAD_TOL)
  bad = {k: (v, limit(k)) for k, v in errs.items()
         if not (v[0] <= limit(k)[0] and v[1] <= limit(k)[1])}
  if bad:
    raise AssertionError(f"layers differ from the CPU beyond their limits "
                         f"(error, limit): {bad}")
  log("dropped shares on the card: " + ", ".join(
      f"{k} {s:.6f} (rate {rate}" + (f", {XV_DROP_SIGMAS} sd {sd:.2g})"
                                     if sd else ")")
      for k, (s, rate, sd) in shares.items()))
  for k, (s, rate, sd) in shares.items():
    if sd is not None and abs(s - rate) > XV_DROP_SIGMAS * sd:
      raise AssertionError(f"{k} dropped {s}, rate {rate}")
    if sd is None and not 0.8 * rate <= s <= 1.05 * rate:
      raise AssertionError(f"{k} dropped {s}, rate {rate}")
  utt = np.array([int(re.search(r"_u(\d+)", os.path.basename(f)).group(1))
                  for f in files])
  return counts["logmel_fft"], dict(raw=raw, spk=spk, utt=utt, vecs=vecs)


# -- phase 22: classical ML on K1's frames and the x-vectors ---------------
CL_COMPONENTS = PCA_COMPONENTS  # 20 components of the 40-mel log-mels
CL_MB_BATCH = 65536  # MiniBatchPCA's batch
CL_TRAIN_UTT = 24  # utterances 0-23 of each speaker train, 24-31 test
CL_ALGOS = ("lda", "svm", "logistic", "gbt", "rf")
# linear_classifier's keywords: the SVC with Platt probabilities, which
# evaluate reads (scikit-learn's SVC has none without them)
CL_ALGO_KW = {"svm": dict(probability=True, random_state=SEED)}
CL_TOPICS = dict(n_docs=TOPIC_CONFIG["n_docs"],
                 n_words=TOPIC_CONFIG["n_words"],
                 n_topics=TOPIC_CONFIG["n_topics"])  # phase 18's corpus
# 22.1, each reduction against a float64 eigh of the frames' covariance on
# the card: the largest relative error of its explained variances (None:
# PPCA has none), the largest principal angle (radians) between the top
# 20 - drop eigenvectors and its subspace, and the least share of the top
# subspace's variance that its subspace captures.  The port's CPU run at
# full size (tools/classical_recipe.py --files 2048: 1,220,944 frames)
# measured: fast_pca (covariance_eigh, X'X in float32 as scikit-learn
# forms it) 5.77e-5, 5.33e-4, 1 - 1.6e-9; fast_pca(randomized) 1.15e-5,
# 1.98e-3, 1 - 1.4e-8; RandomizedPCA (a sketch of all 40 columns)
# 2.53e-6, 5.83e-6, 1 - 1.1e-13; MiniBatchPCA (incremental: each batch
# keeps 20 directions, an approximation of its own) 1.76e-2, 0.123 for
# the top 19, 1 - 9.5e-5; PPCA (EM, stopped by its sigma2 test after 17
# steps) 0.0151 for the top 19 (how far EM has turned them by its stop:
# 0.019 a step earlier, 0.024 two, 2e-3 at 25 steps), 1 - 5.2e-4; the
# 20th direction is left out of the angles of both, its eigenvalue
# (16.80) within 12 % of the 21st (14.87).  The limits are 10-40x the
# rounding-bound figures and 2.5-6x the algorithms' own (PPCA's angle
# limit was 1e-2 in the first card run, set from a misread figure, and
# failed there at the same 0.0151):
CL_LIMITS = {  # name: (explained variance, angle, drop, captured share)
    "fast_pca": (1e-3, 1e-2, 0, 1 - 1e-6),
    "fast_pca(randomized)": (1e-3, 2e-2, 0, 1 - 1e-6),
    "RandomizedPCA": (1e-4, 1e-3, 0, 1 - 1e-9),
    "MiniBatchPCA": (5e-2, 0.3, 1, 1 - 5e-4),
    "PPCA": (None, 5e-2, 1, 1 - 3e-3)}
# 22.2, the back-ends on the held-out x-vectors: each accuracy at least
# 1/1.5 of, and each EER at most 1.5x, the port's CPU run of the same
# back-ends on x-vectors that phase 21's recipe made on the card
# (tools/classical_recipe.py --files 2048 --stages 5 --trees 20 --vectors
# X.npy, X from `--device cuda --steps 1200 --frames 0`: that run's PLDA
# EER 0.2309), at a reduced scale: the boosted trees at 5 stages and the
# forest at 20 trees (the CPU took 32 s a stage and 0.6 s a tree; the
# logistic regression's dense Newton 1884 s).  Chance accuracy is 1/64;
# EERs are capped at chance's 0.5, which binds for lda, gbt and
# GMMclassifier, whose accuracy floors (9-16x chance) and 22.4 hold
# them.  (accuracy, EER):
CL_CPU = {"Scorer(lda=True)": dict(accuracy=0.388671875, EER=0.1117),
          "Scorer(svm)": dict(accuracy=0.41796875, EER=0.0840),
          "lda": dict(accuracy=0.375, EER=0.3402),
          "svm": dict(accuracy=0.453125, EER=0.0738),
          "logistic": dict(accuracy=0.408203125, EER=0.2047),
          "gbt": dict(accuracy=0.21875, EER=0.3438),
          "rf": dict(accuracy=0.35546875, EER=0.1208),
          "GMMclassifier": dict(accuracy=0.2578125, EER=0.3901),
          "ProbabilisticEmbedding": dict(accuracy=0.32421875, EER=0.1810)}
CL_RATIO = 1.5
# 22.4, the card against the CPU from the same inputs at small shapes, each
# of the CPU value's largest magnitude; 100x or more the CPU's own float32
# distance from float64 (tools/classical_recipe.py, "fp32", on the
# card's x-vectors as above: PCA components 6.84e-4, as scikit-learn
# forms X'X in float32; the LDA transform 4.26e-6; the mixture's weights
# 2.34e-7, means 6.25e-7, score_samples 2.91e-6; the GMM classifier's
# log-likelihoods 1.51e-5; the topics' components 8.9e-7; evaluate's
# figures 2.76e-6).  The SVC computes in float64 whatever its input (0
# from float32): its limit is libsvm's stop, which leaves decision values
# up to about tol = 1e-3 apart wherever two runs' rounding picks other
# working sets (tests/test_torch_svm.py), and its Platt probabilities as
# far times |A|/4 (Platt's slopes |A| up to 2.61 here).  The forest's
# splits are chosen from integer sums and float32 thresholds on both
# devices; the boosted trees' fit is the same bits on both, so their raw
# scores are equal (limit 0: a last-bit difference in a residual can turn a
# split and every stage after it, and one card run read probabilities
# 0.090 apart when the residuals' exp and sums were torch's).  The two
# models' probabilities differ by the order of a float64 sum.  The
# logistic regression runs Newton in float64 to its stop, and the
# embedding is float64 on its probabilities: both within float64's
# rounding.
CL_CARD = {"pca_components": 7e-2, "lda_transform": 8e-3,
           "mixture_weights": 1e-5, "mixture_means": 4e-5,
           "mixture_score_samples": 2e-4, "svc_decision": 1e-3,
           "svc_proba": 1e-3, "forest_proba": 1e-12, "gbt_raw": 0.0,
           "gbt_proba": 1e-12,
           "logistic_proba": 1e-9, "embedding_proba": 1e-9,
           "gmm_classifier_llk": 1.5e-3, "topics_components": 1e-4,
           "evaluate": 1e-3}
CL_SMALL_FRAMES = 8192  # frames of the PCA, rows of the mixture
CL_SMALL_SPEAKERS = 8  # speakers of the classifiers' comparisons
CL_SMALL_STAGES = 10  # the boosted trees' stages there (0.45 s a stage on
# the CPU)


def principal_angle(torch, rows, basis):
  """The largest principal angle (radians) between the orthonormal
  columns of `basis` (d, m) and the span of `rows` (k, d), m <= k, in
  float64: 0 where the span holds every column."""
  Q = torch.linalg.qr(rows.T.to(torch.float64))[0]
  s = torch.linalg.svdvals(Q.T @ basis)
  return float(torch.arccos(torch.clamp(s.min(), max=1.0)))


def captured_share(torch, rows, C, top):
  """The variance of covariance C inside the span of `rows` (k, d) over
  the most any k-dimensional subspace holds (the sum of the `top`
  eigenvalues), in float64: 1 for the principal subspace."""
  Q = torch.linalg.qr(rows.T.to(torch.float64))[0]
  return float(torch.trace(Q.T @ C @ Q) / top.sum())


def mel_energy_db(torch, mspec):
  """A frame's log-energy in dB from its log-mel bands in dB."""
  c = math.log(10.0) / 10.0
  return torch.logsumexp(mspec * c, dim=1) / c


def classical_reductions(torch, np, frames, device, sync):
  """22.1: the five reductions of `frames` (N, 40) at CL_COMPONENTS and
  GMMThreshold on their log-energy, each against a float64 eigh of the
  covariance on `device`; -> {name: (explained-variance error or None,
  principal angle, captured variance share, seconds)}, and the
  threshold's (low mean, threshold, high mean, seconds)."""
  from odin_tpu_torch.ml import (MiniBatchPCA, PPCA, GMMThreshold,
                                 RandomizedPCA, fast_pca)
  k = CL_COMPONENTS
  F = frames.to(torch.float64)
  C = torch.cov(F.T)
  evals, evecs = torch.linalg.eigh(C)
  evals, evecs = torch.flip(evals, [0])[:k], torch.flip(evecs, [1])[:, :k]

  def timed(fn):
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t

  fits = {
      "fast_pca": lambda: fast_pca(frames, n_components=k,
                                   return_model=True)[1],
      "fast_pca(randomized)": lambda: fast_pca(
          frames, n_components=k, svd_solver="randomized",
          return_model=True)[1],
      "RandomizedPCA": lambda: RandomizedPCA(k, random_state=SEED).fit(
          frames),
      "MiniBatchPCA": lambda: MiniBatchPCA(k, batch_size=CL_MB_BATCH).fit(
          frames),
      "PPCA": lambda: PPCA(k).fit(frames)}
  out = {}
  for name, fit in fits.items():
    model, secs = timed(fit)
    if name == "PPCA":
      rows, ev = model.W.T, None
    else:
      model = model._model if name == "MiniBatchPCA" else model
      rows = model.components_
      ev = float(((model.explained_variance_.to(torch.float64) - evals
                   ).abs() / evals).max())
    drop = CL_LIMITS[name][2]
    out[name] = (ev, principal_angle(torch, rows, evecs[:, :k - drop]),
                 captured_share(torch, rows, C, evals), secs)
  energy = mel_energy_db(torch, frames)
  th, secs = timed(lambda: GMMThreshold().fit(energy))
  means = th.gmm_.means_.reshape(-1).cpu().numpy()
  return out, (float(means.min()), th.threshold_, float(means.max()), secs)


def classical_backends(torch, np, vecs, spk, utt, device, sync,
                       pdf_path=None, cuts=None):
  """22.2: the back-ends on the x-vectors (utterances below CL_TRAIN_UTT
  train, the rest test), each through ``evaluate``; `cuts` may give an
  algorithm's keywords (the CPU run cuts the trees' counts); -> {name:
  the evaluate dict plus 'seconds'}."""
  from odin_tpu_torch.ml import (GMMclassifier, ProbabilisticEmbedding,
                                 Scorer, evaluate, linear_classifier)
  train = utt < CL_TRAIN_UTT
  tr_t = torch.from_numpy(train).to(vecs.device)
  Xtr, Xte = vecs[tr_t], vecs[~tr_t]
  ytr, yte = spk[train], spk[~train]
  results = {}

  def run(name, fit, proba, path=None):
    sync()
    t = time.perf_counter()
    model = fit()
    p = proba(model)
    sync()
    secs = time.perf_counter() - t
    r = evaluate(yte, p, print_log=False, path=path, device=device)
    r["seconds"] = secs
    results[name] = r
    return model

  run("Scorer(lda=True)", lambda: Scorer(lda=True, device=device).fit(
      Xtr, ytr), lambda m: m.predict_proba(Xte), pdf_path)
  run("Scorer(svm)", lambda: Scorer(method="svm", device=device).fit(
      Xtr, ytr), lambda m: m.predict_proba(Xte))
  models = {}
  for algo in CL_ALGOS:  # each estimator runs on the device of Xtr
    kw = dict(CL_ALGO_KW.get(algo, {}), **(cuts or {}).get(algo, {}))
    models[algo] = run(algo, lambda: linear_classifier(Xtr, ytr, algo=algo,
                                                       **kw),
                       lambda m: m.predict_proba(Xte))
  run("GMMclassifier", lambda: GMMclassifier(device=device).fit(Xtr, ytr),
      lambda m: m.predict_proba(Xte))
  probs = models["logistic"].predict_proba(Xte)
  run("ProbabilisticEmbedding", lambda: ProbabilisticEmbedding(
      device=device).fit(probs), lambda m: m.predict_proba(probs))
  return results


def classical_topics(torch, np, device, sync):
  """22.3: ``fast_lda_topics`` on phase 18's ``SyntheticBoW`` at its true
  topic count, the perplexity after each EM step; -> (model, perplexities,
  the topic strings, the recovered topics' mean best-match cosine,
  seconds)."""
  from odin_tpu_torch.fuel.nlp_data import SyntheticBoW
  from odin_tpu_torch.ml import fast_lda_topics, get_topics_string
  ds = SyntheticBoW(**CL_TOPICS, seed=1)
  X = torch.from_numpy(ds._x).to(device)
  sync()
  t = time.perf_counter()
  lda = fast_lda_topics(X, n_topics=CL_TOPICS["n_topics"], evaluate_every=1)
  sync()
  secs = time.perf_counter() - t
  words = [f"w{i:03d}" for i in range(CL_TOPICS["n_words"])]
  comp = lda.components_.to(torch.float64).cpu().numpy()
  comp = comp / comp.sum(1, keepdims=True)
  sims = comp @ ds.topics.T / (np.linalg.norm(comp, axis=1)[:, None] *
                               np.linalg.norm(ds.topics, axis=1)[None])
  return (lda, list(lda.perplexities_), get_topics_string(lda, words),
          float(sims.max(1).mean()), secs)


def classical_small(torch, np, frames, vecs, spk, utt, device,
                    dtype=None):
  """22.4's small shapes on `device` (in `dtype` where given, else the
  inputs' own): PCA components, the LDA transform, the diagonal mixture's
  weights, means and score_samples, the SVC's decision values and Platt
  probabilities, the probabilities of the forest, the logistic
  regression, the boosted trees (and their raw scores) and the
  probabilistic embedding (of the
  logistic model's probabilities, as 22.2 fits it), the GMM classifier's
  log-likelihoods, the topic model's components and evaluate's dict; ->
  {name: array}."""
  from odin_tpu_torch.fuel.nlp_data import SyntheticBoW
  from odin_tpu_torch.ml import (GMMclassifier, ProbabilisticEmbedding,
                                 evaluate, fast_lda_topics, fast_pca,
                                 linear_classifier)
  from odin_tpu_torch.ml.discriminant import LinearDiscriminantAnalysis
  from odin_tpu_torch.ml.forest import RandomForestClassifier
  from odin_tpu_torch.ml.mixture import GaussianMixture
  from odin_tpu_torch.ml.svm import SVC

  def on(x):
    x = torch.as_tensor(x).to(device)
    return x if dtype is None else x.to(dtype)

  host = lambda t: t.detach().to(torch.float64).cpu().numpy()
  out = {}
  F = on(frames[:CL_SMALL_FRAMES])
  _, pca = fast_pca(F, n_components=CL_COMPONENTS, return_model=True)
  out["pca_components"] = host(pca.components_)
  keep = spk < CL_SMALL_SPEAKERS
  train = keep & (utt < CL_TRAIN_UTT)
  test = keep & (utt >= CL_TRAIN_UTT)
  V = on(vecs)
  Xtr, Xte = V[torch.from_numpy(train)], V[torch.from_numpy(test)]
  ytr, yte = spk[train], spk[test]
  lda = LinearDiscriminantAnalysis(device=device).fit(Xtr, ytr)
  out["lda_transform"] = host(lda.transform(Xte))
  gm = GaussianMixture(2, covariance_type="diag", random_state=1,
                       device=device).fit(Xtr[:, :16])
  out["mixture_weights"] = host(gm.weights_)
  out["mixture_means"] = host(gm.means_)
  out["mixture_score_samples"] = host(gm.score_samples(Xte[:, :16]))
  # with Scorer(svm)'s and linear_classifier('svm')'s probabilities,
  # seeded (Scorer's SVC draws its folds unseeded, as JAX's does); the
  # decision values are the full fit's, which the folds leave as they are
  svc = SVC(kernel="linear", probability=True, random_state=SEED,
            device=device).fit(Xtr, ytr)
  out["svc_decision"] = host(svc.decision_function(Xte))
  out["svc_proba"] = host(svc.predict_proba(Xte))
  rf = RandomForestClassifier(n_estimators=20, random_state=1,
                              device=device).fit(Xtr, ytr)
  out["forest_proba"] = host(rf.predict_proba(Xte))
  probs = linear_classifier(Xtr, ytr, algo="logistic").predict_proba(Xte)
  out["logistic_proba"] = host(probs)
  gbt = linear_classifier(Xtr, ytr, algo="gbt", n_estimators=CL_SMALL_STAGES)
  out["gbt_raw"] = host(gbt.decision_function(Xte))
  out["gbt_proba"] = host(gbt.predict_proba(Xte))
  # its log-likelihoods plus log priors (its probabilities are 0 or 1 in
  # 512 dimensions)
  out["gmm_classifier_llk"] = host(GMMclassifier(device=device).fit(
      Xtr, ytr).decision_function(Xte))
  out["embedding_proba"] = host(ProbabilisticEmbedding(device=device).fit(
      probs).predict_proba(probs))
  ds = SyntheticBoW(n_docs=300, n_words=60, n_topics=4, seed=1)
  topics = fast_lda_topics(on(ds._x), n_topics=4)
  out["topics_components"] = host(topics.components_)
  r = evaluate(yte, lda.predict_proba(Xte), print_log=False, device=device)
  out["evaluate"] = np.array([r["log_loss"], r["accuracy"], r["Cnorm"],
                              r["EER"], r["minDCF"]])
  return out


def apart(np, got, want):
  """|got - want| over want's largest magnitude, per entry of the dicts;
  the LDA transform's columns first signed as want's (an SVD's signs are
  no convention)."""
  got = dict(got)
  g, w = got["lda_transform"], want["lda_transform"]
  got["lda_transform"] = g * np.where(np.sum(g * w, 0) < 0, -1.0, 1.0)
  return {k: float(np.abs(got[k] - want[k]).max() /
                   max(np.abs(want[k]).max(), 1e-300)) for k in want}


def classical_path(torch, np, reset_counts, read_counts, smi, xv):
  """Phase 22 (see the constants above): K1's frames of phase 9's files,
  the reductions and GMMThreshold on them, the back-ends on phase 21's
  x-vectors, topics, and the card against the CPU at small shapes;
  returns K1's launches on the path."""
  import os
  import tempfile

  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.preprocessing import batch_speech_features

  cuda = torch.device("cuda", 0)
  sync = torch.cuda.synchronize
  raw, spk, utt, vecs = xv["raw"], xv["spk"], xv["utt"], xv["vecs"]
  # -- 22.1 K1's log-mels, then the reductions
  reset_counts()
  sync()
  t0 = time.perf_counter()
  feats = batch_speech_features(raw, FeatureConfig(), features=("mspec",),
                                device="cuda")
  frames = torch.from_numpy(np.concatenate([f["mspec"] for f in feats])).to(
      cuda)
  sync()
  feat_s = time.perf_counter() - t0
  counts = read_counts()
  n_batches = -(-len(raw) // CORPUS_BATCH)
  log(f"classical path features: {len(raw)} files, {frames.shape[0]} "
      f"frames x {frames.shape[1]} mels ({frames.numel() * 4 / 1e6:.1f} MB "
      f"of float32 on the card) in {feat_s:.3f} s; launches {counts}")
  if counts["logmel"] != n_batches or counts["logmel_fft"] != n_batches:
    raise AssertionError(f"the classical path launched K1 {counts}, not "
                         f"once a batch ({n_batches})")
  red, (lo, thr, hi, th_s) = classical_reductions(torch, np, frames, cuda,
                                                  sync)
  for name, (ev, angle, share, secs) in red.items():
    ev_max, angle_max, drop, share_min = CL_LIMITS[name]
    log(f"22.1 {name}: {secs:.3f} s; explained variance against float64 "
        f"eigh {'-' if ev is None else f'{ev:.3g}'} (limit {ev_max}), "
        f"largest principal angle to the top {CL_COMPONENTS - drop} "
        f"eigenvectors {angle:.3g} rad (limit {angle_max}), captured "
        f"variance share 1 - {1 - share:.3g} (min 1 - {1 - share_min:.3g})")
  log(f"22.1 GMMThreshold on {frames.shape[0]} frame energies: {th_s:.3f} "
      f"s; modes {lo:.4f} and {hi:.4f} dB, threshold {thr:.4f} dB")
  bad = {n: v for n, v in red.items() if not (
      (v[0] is None or v[0] <= CL_LIMITS[n][0]) and
      v[1] <= CL_LIMITS[n][1] and v[2] >= CL_LIMITS[n][3])}
  if bad:
    raise AssertionError(f"reductions off the float64 eigh: {bad}")
  if not lo < thr < hi:
    raise AssertionError(f"GMMThreshold {thr} not between {lo} and {hi}")
  # -- 22.2 the back-ends on the x-vectors; the Scorer(lda=True) report's
  # PDF where matplotlib is installed (the card's machine may lack it;
  # tests/test_torch_ml_wrappers.py writes it on the CPU)
  import importlib.util
  drawn = importlib.util.find_spec("matplotlib") is not None
  with tempfile.TemporaryDirectory() as tmp:
    pdf = os.path.join(tmp, "report.pdf") if drawn else None
    res = classical_backends(torch, np, vecs, spk, utt, "cuda", sync, pdf)
    pdf_note = (f"a {os.path.getsize(pdf)}-byte PDF" if drawn else
                "no PDF: matplotlib is not installed here")
  for name, r in res.items():
    cpu = CL_CPU.get(name, {})
    log(f"22.2 {name}: {r['seconds']:.3f} s; accuracy {r['accuracy']:.6f} "
        f"(min {cpu.get('accuracy', 0) / CL_RATIO:.4f}), EER "
        f"{r['EER']:.6f} (max {min(0.5, cpu.get('EER', 1) * CL_RATIO):.4f})"
        f", minDCF {r['minDCF']:.6f}, Cnorm {r['Cnorm']:.6f}, log loss "
        f"{r['log_loss']:.6f}")
  log(f"22.2 the Scorer(lda=True) report: {pdf_note}; {smi}")
  bad = {n: (r["accuracy"], r["EER"]) for n, r in res.items() if not (
      r["accuracy"] >= CL_CPU[n]["accuracy"] / CL_RATIO and
      r["EER"] <= min(0.5, CL_CPU[n]["EER"] * CL_RATIO))}
  if bad:
    raise AssertionError(f"back-ends beyond their limits: {bad}")
  # -- 22.3 topics
  lda, ppl, strings, match, tp_s = classical_topics(torch, np, "cuda", sync)
  log(f"22.3 fast_lda_topics on SyntheticBoW{tuple(CL_TOPICS.values())}: "
      f"{tp_s:.3f} s, perplexity {ppl[0]:.4f} -> {ppl[-1]:.4f} over "
      f"{len(ppl)} EM steps, best-match cosine to the true topics "
      f"{match:.4f}")
  for line in strings:
    log(f"  {line}")
  if not ppl[-1] < ppl[0]:
    raise AssertionError(f"the perplexity did not fall: {ppl}")
  # -- 22.4 the card against the CPU at small shapes
  t0 = time.perf_counter()
  card = classical_small(torch, np, frames.cpu().numpy(), vecs.cpu(), spk,
                         utt, "cuda")
  cpu = classical_small(torch, np, frames.cpu().numpy(), vecs.cpu(), spk,
                        utt, "cpu")
  err = apart(np, card, cpu)
  log(f"22.4 card against CPU ({time.perf_counter() - t0:.3f} s): " +
      ", ".join(f"{k} {v:.3g} (limit {CL_CARD[k]})" for k, v in err.items()))
  bad = {k: v for k, v in err.items() if not v <= CL_CARD[k]}
  if bad:
    raise AssertionError(f"the card differs from the CPU: {bad}")
  return counts["logmel_fft"]


PHASES = tuple(range(1, 23))
# the phases whose results a phase reads: the kernel reports of 2 and 5,
# phase 7's graphed step time, phase 8's model, phase 9's wav files, phase
# 10's Gym, phase 21's x-vectors
PHASE_NEEDS = {3: (2,), 6: (5,), 8: (7,), 10: (8,), 11: (2, 9), 15: (10,),
               16: (9,), 21: (9,), 22: (9, 21)}


def selected_phases(spec=None):
  """The phases ``--phases`` names (`spec`, e.g. '1,14'), with phase 1 (the
  build) and every phase that a chosen one reads; every phase without a
  spec, as the script runs with no argument."""
  if spec is None:
    return set(PHASES)
  chosen = {1} | {int(p) for p in str(spec).split(",") if p.strip()}
  if not chosen <= set(PHASES):
    raise SystemExit(f"chip_smoke.py --phases: no phase "
                     f"{sorted(chosen - set(PHASES))}; phases are "
                     f"1-{PHASES[-1]}")
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
  # the datasets' files and full-grid caches lie under $ODIN_TPU_HOME
  # (~/.odin_tpu without it): the script keeps its own under build/, so
  # that it reads no dataset file of the user's and writes nothing outside
  # the checkout
  import os
  os.environ["ODIN_TPU_HOME"] = os.path.join(
      os.path.dirname(os.path.abspath(__file__)), "build", "odin_tpu_home")

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
  # phase 19's data files likewise, while phases 2-18 run
  images_writer = None
  if 19 in phases:
    images_writer = start_images_writer()
    atexit.register(lambda: (images_writer.poll() is None and
                             images_writer.kill(), images_writer.wait()))

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

  # phase 16 reads phase 9's wav files, so it runs before they go
  if 16 in phases:
    with Phase("16 extractor path: native IO, FeatureProcessor over forked "
               "workers, the NumPy DSP path against K1, BNF on the card"):
      k1 = extractor_path(torch, np, reset_counts, read_counts, smi)
      if "logmel_fft" in report:
        report["logmel_fft"]["launches"] += k1
      log(f"K1 FFT launches on the extractor path (phase 16): {k1}")
  # phase 21 reads phase 9's wav files too
  if 21 in phases:
    with Phase("21 x-vector path: TDNN layers and XVectorNet trained by the "
               "VoxCeleb recipe on K1's features, PLDA and EER; the other "
               "network layers against the CPU"):
      k1, xv = xvector_path(torch, np, reset_counts, read_counts, smi)
      if "logmel_fft" in report:
        report["logmel_fft"]["launches"] += k1
      log(f"K1 FFT launches on the x-vector path (phase 21): {k1}")
  # phase 22 reads phase 21's x-vectors and phase 9's utterances
  if 22 in phases:
    with Phase("22 classical path: the PCA family, PPCA and GMMThreshold on "
               "K1's frames; LDA, SVM, logistic, boosted trees, forests and "
               "GMMs on the x-vectors; topics; the card against the CPU"):
      k1 = classical_path(torch, np, reset_counts, read_counts, smi, xv)
      if "logmel_fft" in report:
        report["logmel_fft"]["launches"] += k1
      log(f"K1 FFT launches on the classical path (phase 22): {k1}")
      del xv
  if 9 in phases:
    import shutil
    shutil.rmtree(corpus_root(), ignore_errors=True)

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

  if 17 in phases:
    with Phase("17 sweep path: Shapes3D, both trunks, multi-seed training, "
               "remat policies, run_hydra and the ScoreBoard"):
      sweep_path(torch, np, reset_counts, read_counts, smi)

  if 18 in phases:
    with Phase("18 last path: the LDA family, Grade of Membership, the "
               "cycle-consistent VAE, the mixture of experts and the "
               "sequential family on K1's log-mels"):
      k1 = last_path(torch, np, reset_counts, read_counts, smi)
      if "logmel_fft" in report:
        report["logmel_fft"]["launches"] += k1
      log(f"K1 FFT launches on the last path (phase 18): {k1}")

  if 19 in phases:
    with Phase("19 images path: the natural-image VAEs (MNIST- and "
               "CIFAR-shaped files, their networks and likelihoods)"):
      images_path(torch, np, reset_counts, read_counts, smi, images_writer)
      import shutil
      shutil.rmtree(images_root(), ignore_errors=True)

  if 20 in phases:
    with Phase("20 genes path: the distribution zoo and the gene-expression "
               "VAEs (count likelihoods, cortex and pbmc networks)"):
      genes_path(torch, np, reset_counts, read_counts, smi)

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
  if sys.argv[1:2] == ["--multiseed-profile"]:
    sys.exit(multiseed_profile(sys.argv[2:]))
  if sys.argv[1:2] == ["--last-rehearsal"]:
    sys.exit(last_rehearsal(sys.argv[2:]))
  if sys.argv[1:2] == ["--images-rehearsal"]:
    sys.exit(images_rehearsal(sys.argv[2:]))
  if sys.argv[1:2] == ["--genes-rehearsal"]:
    sys.exit(genes_rehearsal(sys.argv[2:]))
  if sys.argv[1:2] == ["--write-images"]:
    write_images(sys.argv[2])
    sys.exit(0)
  if sys.argv[1:2] == ["--trunk-conditioning"]:
    sys.exit(trunk_conditioning(sys.argv[2:]))
  if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
    sys.exit(main(selected_phases(sys.argv[2])))
  if sys.argv[1:]:
    raise SystemExit(f"chip_smoke.py: unknown arguments {sys.argv[1:]}")
  sys.exit(main())
