#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tim_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit (and the SM clock, for the exponential floors); TF32 stays at
     PyTorch's defaults, as the entry points run; the
     CPU references use no more threads than the host lets it use;
  2. build: compiles the CUDA kernels from ``tim_tpu_torch/csrc`` (one
     nvcc per source, all started together); prints each source's compile
     seconds and each attention kernel's registers and spills (ptxas);
  3. kernels: each kernel against its plain PyTorch version on the card
     (kernels 1 and 2 in fp32 and bf16 at batch 16, kernel 1's bf16 gate
     scaled to its output and shown to reject two faulty controls: the
     self term dropped, the output x 0.98; kernel 2's bf16 gate, the flat
     bound and a relative RMS, shown to reject two: b2 omitted, LN2's
     statistics over half the row; kernel 3 with fp32 and
     bf16 output, with and without bias and GELU, N in {3806, 44, 256},
     ragged M, strided inputs), then timed (CUDA events) at the serving
     shapes (bf16, batch 128) beside its plain version and one library
     route for the same function; the least time the card could take is
     computed from the same shapes (kernel 2 also beside its two bare
     bf16 products through ``torch.matmul``); then the bf16 linear against
     its own
     fp32-accumulator reference rounded per kind (TORCH_LINEAR, DENSE),
     bit-equal on exact sums, timed beside the route before the repair,
     and the linears' bias epilogue kernel (``csrc/bias_act.cu``: the
     bias add rounded per kind, with the MLPs' GELU) against its plain
     version at the backbones' shapes, timed;
  4. fp32 slice: ``make_inference_step`` of a full-width EPIC detection
     TimDetection (random weights from a seeded generator) on 2 windows,
     on the card with the kernels and on the CPU with the plain versions;
  5. bf16 serving: ``DetectionServer.detect_video`` (batch 128, top-8)
     over a synthetic 300 s video; kernels 1 and 2 launched once per
     encoder layer per batch; bf16 vs fp32 scores on the 2 windows;
  6. int8 fp32 slice: ``DetectionServer.quantized`` at full width in fp32
     with the fused int8 heads, calibrated on the 2 windows, against the
     same int8 model on the CPU; the card's calibrated scales against the
     CPU's;
  7. int8 serving: ``detect_video`` in int8 static serving (bf16 compute,
     fused heads) on the same video: kernel 1 launched 6 times per batch,
     kernel 2 never, kernel 3 twice; int8 vs bf16 scores on the 2 windows
     within the repo's contract (max 0.1, mean 0.01);
  8. headline mode: the same with bf16 attention scores (``fast_scores``):
     kernel 1 never launched, kernel 3 twice per batch;
  9. backbone kernels: kernel 4 (window attention) against its plain
     version in fp32 and bf16 at each Swin-B stage shape of one 32 x 224^2
     clip (shifted and unshifted blocks; stage 4 has one window type) and
     kernel 5 (flash attention) at S 1568, 160 and a ragged 37 and the MAE
     decoder's 8 heads, each as its inference and its training launch
     (the row lse against the plain log-sum-exp; the bf16 gate also shown
     to reject two faulty controls), then both timed at batch 8 at every
     shape the paths launch (kernel 4: every stage; kernel 5: ViT-L, the
     MAE encoder and decoder) beside the plain version, the library call
     without and with inputs that require grad (the call that keeps its
     lse), the bound and the exponential floor;
 10. backbone fp32 slices: full-width Swin-B (32 x 224^2) and ViT-L
     (16 x 224^2) on one clip, on the card with the kernels against the
     CPU with the plain versions; 24 launches per forward;
 11. extraction: ``make_visual_apply`` (bf16, batch 8) and
     ``extract_features_for_video`` over a synthetic video of 64 clips
     per backbone: device and wall clips/s, kernel 4 (Swin-B) and kernel 5
     (ViT-L) launched 24 times per forward; bf16 vs fp32 features on 2
     clips;
 12. training kernels: the backward of kernel 4 at every Swin-B stage
     shape (2 clips, shifted and unshifted) and of kernel 5 at
     [2, 16, 1568, 64], S 160 (MAE encoder), ragged S 37 and the MAE
     decoder's [2, 8, 1568, 64], against the plain backwards in fp32 and
     bf16 (the bf16 gate shown to reject faulty controls: D omitted,
     dbias from one window, dbias without one of the window groups the
     kernel sums over), then timed at batch 8 beside the plain
     backward and the backward of ``scaled_dot_product_attention``
     (and their share of the bound); kernels 4b's and 5b's deterministic
     routes (``torch.use_deterministic_algorithms``): two calls bit-equal,
     within the gate, timed;
 13. fp32 gradient slices: full-width ViT-L (2 blocks) and Swin-B (depths
     2, 2, 2, 2) ``TwoHeadViT`` on one clip, every parameter gradient on
     the card against the CPU;
 14. finetune steps at full width and depth in bf16, batch 8:
     ``BackboneFinetuneRunner`` over ViT-L (LLRD AdamW, mixup 0.8) and
     ``make_two_head_step`` + AdamW over Swin-B, 2 warm-up and 5 timed
     steps each: ms per step, clips/s, peak memory; 24 launches of
     kernel 4 or 5 and 24 of its backward per step, nothing else;
 15. MAE pretraining: ``BackbonePretrainRunner`` over ``PretrainVideoMAE``
     (ViT-L encoder, 512 x 12 decoder) in bf16, batch 8, mask 0.9: 36
     launches of kernel 5 and 36 of its backward per step;
 16. TIM detection training at the full width of ``epic_detection``
     (S = 898, 3806 + 44 classes), on synthetic splits of 484 windows
     built from numpy (real feature widths, two augmentation sets):
     a. one fp32 train step of the model cut to 2 encoder layers (every
        dropout rate 0, drloc 0.3) on 2 windows, card vs CPU with the same
        draws: losses and metrics within 1e-4 relative, every parameter
        gradient within 1e-3 of its largest value, the normaliser;
     b. ``DetectionRunner.train_epoch`` on the banked path, bf16, batch
        64, every dropout on: 2 warm-up and 5 timed steps (ms a step,
        device and wall windows/s, peak memory); finite losses and
        gradient norms, every parameter moved, the normaliser moved off
        250, kernels 1 and 2 never launched, the bias epilogue steady;
     c. ``validate`` of those weights in bf16 on the banked and the host
        path and in fp32: kernel 1 six times a batch, kernel 2 never;
        the paths within 1e-3, bf16 vs fp32 within 2e-2 relative;
     d. the state saved, ``resume``d into a fresh runner (step,
        normaliser, optimizer state and parameters equal), one more step
        from both: parameters within 1e-5 of each tensor's largest;
 18. the detection mAP chain, on phase 16's runner (its regression heads'
     two sigmoids biased apart) and validation split:
     ``extract_dense_predictions`` top-8 on the banked path (kernel 1 six
     times a batch) and the host path (the same rows, within 1e-3), the
     top-8 columns against a dense dump of 64 windows, ``evaluate_detections``
     of the banked dump against the split's GT (seconds of the dump and of
     the evaluation); an fp32 dump of 4 windows card vs CPU (within 1e-3)
     and their avg mAP against GT made of the CPU dump's best detections
     (within 1e-6); the GT fed back as predictions gives avg mAP 1.0;
 17. TIM recognition at the full width of ``epic_recognition`` (4
     layers, heads 97/300/3806/44), the class heads' weights x4 so that
     random logits spread, on synthetic splits of 484 windows from numpy:
     a. the fp32 forward of 2 windows card vs CPU (1e-3 of the largest
        logit; kernel 1 once a layer);
     b. kernel 1 against its plain version at the recognition shapes,
        serving [64, 8, 4, 128] and validation [64, 8, 3 nv + na, 128],
        fp32 and bf16 (the gate rejecting the self term dropped), timed
        beside its plain version and masked SDPA;
     c. ``RecognitionServer.classify_intervals`` (ensemble 5, batch 64) of
        200 intervals of a synthetic 300 s video in fp32, bf16, int8
        static and bf16 with the fused tail (kernel 1 four times a batch
        on each, kernel 2 only on the last, kernel 3 never): device and
        wall intervals/s; bf16 vs fp32 probabilities within 0.1; int8 vs
        fp32 top-1 agreement >= 0.75 and probabilities within 0.25;
     d. an fp32 train step at depth 2 card vs CPU (losses 1e-4 relative,
        gradients 1e-3 of each largest but the k bias); 2 + 5 bf16
        ``RecognitionRunner`` steps on the banked path at batch 64, every
        dropout on, mixup 0.2, drloc 0.3 (ms a step, windows/s, peak
        memory; kernels 1 and 2 never), one host-path step; the state
        resumed into a fresh runner, one more step from both bit-equal;
     e. ``validate`` banked and host (statistics within 1e-5, kernel 1 four
        times a batch), two banked vote sums bit-equal, and
        ``extract_predictions`` on both paths;
 19. the command lines and the checkpoint gate, on phase 16's and 17's
     splits: ``cli.run`` (banked, bf16, batch 64) ``--variant detection
     --train`` for one epoch (the CLI's EPIC model: 97 verb and 44 audio
     classes), then ``--validate`` and ``--extract_feats --extract_top_k
     8`` resumed from its checkpoint, each against a ``DetectionRunner``
     resumed from the same file (within 1e-3; kernel 1 six times a batch,
     kernel 2 never); ``--variant recognition --validate`` and
     ``--extract_feats`` with ``--torch_checkpoint`` on phase 17's trained
     weights saved in the reference's format, against a
     ``RecognitionRunner`` (kernel 1 four times a batch); then
     ``validate_checkpoint`` on both full-width checkpoints (load, infer,
     convert and contract PASS, parity SKIPs without the reference tree;
     kernel 1 once a layer, kernel 3 twice in the detection contract),
     with each stage's seconds and the contract's numbers;
 20. audio: full-size Auditory SlowFast (R50, width 64, 2304-d feature)
     in fp32 on one clip's spectrogram [1, 1, 200, 128], card vs CPU
     within 1e-3; ``make_audio_apply`` and ``extract_features_for_video``
     with the CLI's clip function over a synthetic 60 s waveform (1.1 s
     records every 0.2 s, a clean and a SpecAugment set, batch 8): device
     and wall clips/s, peak memory, the clean set against per-clip
     forwards (within 1e-4);
 21. raw media, at ``scripts/bench_serve_frames.py``'s geometry (50 fps
     224^2 uint8 frames, a 1.1 s clip every 0.2 s, Swin-B 32 and ViT-L 16
     frames from one origin, spectrograms [400, 128], 30 s windows):
     a. ``make_visual_apply(--quantize_backbone on)`` for Swin-B and ViT-L
        (bf16): features of 2 clips against the bf16 backbone's, dynamic
        (<= 0.08 of the largest) and a calibrated static twin (<= 0.12);
        extraction of 64 clips each way timed (24 launches a forward);
        the int8 forward in fp32 at reduced depth on one clip, card
        against CPU (SLICE_TOL, or ULP_ENVELOPE times the CPU's one-ulp
        spread);
     b. ``DetectionServer.detect_video_frames`` with [Swin-B, ViT-L] and
        SlowFast on bf16 ``epic_detection`` (kernel 2 fused, top-8, batch
        16) over a 40 s video in the modes naive, stream, gather and
        pair_embed: real-time factor each, features within the bf16
        feature gate of naive's, detections against ``detect_video``
        over naive's features (scores within the bf16 score gate, labels
        of the top 50 equal); the stream run's launches (kernels 4 and 5
        24 a forward of 8 clips, 1 and 2 six a detection batch); seconds
        per stage; the device's busy share (``torch.profiler``); the
        bench's own ``fast_scores`` server (dense dump, batch 16); the
        80 s video in stream mode;
     c. one short fp32 raw-media call (4 timesteps), backbones and
        SlowFast cut in depth, the detector at full width, card against
        CPU: labels equal, segments and scores within SLICE_TOL;
     d. ``DetectionServer.quantized`` (fused heads) with the int8
        backbones over the 40 s video: kernel 3 twice a batch.
 22. the backbone finetune CLI (``extract/finetune_cli.py::run``) at ViT-L's
     full width (depth 24, 16 x 224^2, 97 / 300 classes), bf16, batch 8, on
     24 segments of seeded uint8 256 x 456 frames with ``dict`` annotations
     (the finetune clips through the recipe's ``VideoRandAugment`` with PIL
     blocked, ``random`` and ``np.random`` seeded before each run):
     ``--mode pretrain`` (MAE, mask 0.9, 3 steps; 36 launches of
     kernels 5 and 5b a step), then ``--mode finetune --pretrained`` on its
     ``checkpoint.pt`` (every ``blocks.*`` entry loads; num_sample 2, mixup
     0.8, 3 steps: 24 and 24 a step) and its validation (24 of kernel 5 a
     batch): per step the host's data and the step's seconds
     (``PhaseTimer``), clips/s, peak memory; then the finetune CLI in fp32
     at depth 2, one step of 2 segments, card vs CPU: metrics within 1e-4
     relative, every gradient within 1e-4 of its largest;
 23. the data-parallel path (``parallel.multihost``, ``parallel.mesh``): a
     process group of one rank over NCCL, ``cli.run`` ``--train`` (3
     banked steps of 64 and 2 validation batches) and ``--extract_feats``
     for detection (top-8) and recognition on phase 16's and 17's splits,
     each bit-equal to the same runs without a process group (statistics,
     every parameter, every dump column); collective calls per train step
     (not 0); kernel 1 six / four times a batch. The machine has one card:
     two NCCL ranks run in the CPU tests only (gloo);
 24. tensor and sequence parallelism (``parallel.mesh``'s model axis): two
     processes on cuda:0 over gloo with CUDA tensors (data 1 x model 2),
     ``DetectionRunner`` on full-width EPIC detection (6 layers, 3806 + 44
     classes, S = 898), 3 banked bf16 train steps at a global batch of 16
     with sequence parallelism off and on and an fp32 2-layer slice, each
     against the same run in one process (fp32: losses and every parameter
     within 1e-4 of each largest value; bf16: losses within the paths'
     gate, top-8 scores within a same-precision gate that two faulty
     copies of the dump fail); kernel 1 six times a
     validation batch a rank at [16, 4, 798, 128], its first launch held
     to its plain version; ``use_fused_ffn`` validation launching kernel 2
     six times on the gathered FFN weights; the ranks' checkpoint loaded
     strictly into a one-process ``TimDetection`` with the same validation;
     ``dryrun_multichip(1)``; step seconds and collectives per step per
     rank (gloo on one card: not a tensor-parallel speed);
 25. the JAX package's msgpack checkpoints (after 24; the card's machine
     has no flax, so each file is written by the port's encoder,
     ``train.checkpoint.save_jax_checkpoint``): a. an EPIC detection
     ``DetectionRunner`` (bf16, batch 64, phase 16's split) takes 2 banked
     steps and saves ``checkpoint.pt`` and ``checkpoint.msgpack``; fresh
     runners ``resume`` each and take one more step: parameters, moments,
     counters, step, normaliser, epoch and loss bit-equal between the
     routes; the file's bytes, write and decode seconds and MB/s; b.
     ``--pretrained_model`` from each directory into bf16 ``detect_video``
     (kernels 1 and 2) and ``DetectionServer.quantized`` (kernel 3) over 90
     s of the video: detections bit-equal; c. phase 17's recognition
     weights in a state saved both ways, ``cli.run --validate
     --pretrained_model`` (kernel 1): statistics bit-equal; d. (inside
     phase 22) its ``--mode pretrain`` state (ViT-L ``PretrainVideoMAE``,
     AdamW) written as msgpack and the same finetune run from
     ``--pretrained`` on it: the trunk's missing entries and the first
     step's loss (kernels 5 and 5b) bit-equal to the .pt route's; e. the
     file with ``mu`` and ``nu`` swapped in one leaf must resume unequal;
 26. JAX's orbax checkpoint directories (inside phase 25; the card's
     machine has no JAX, orbax or tensorstore: ``utils/{orbax,ocdbt,
     zstd}.py`` over the system's libzstd): a. phase 25's EPIC detection
     state written by ``save_checkpoint_orbax`` (bytes, seconds, MB/s)
     and b. read back by ``load_checkpoint_orbax`` (seconds, MB/s), its
     payload bit-equal to the msgpack file's; a fresh runner ``resume``s
     the directory (``load_checkpoint`` falls back to ``orbax/1``) and
     takes the step: state and loss bit-equal to the .pt and msgpack
     routes; c. ``--pretrained_model`` from it into bf16 and int8
     ``detect_video`` (kernels 1, 2 and 3): detections bit-equal to the
     msgpack route's; d. the committed fixture ``tests/data/torch_orbax``
     (written by JAX: tensorstore's zstd frames) decoded on the card,
     bit-equal to its ``checkpoint.msgpack`` twin, and loaded strictly
     into a small ``TimDetection`` on the card from both; e. a flipped
     byte in one chunk and then a truncated data file of the EPIC
     directory each raise ``ValueError`` naming the key.
 27. the command lines on the reference's files (after 20; the port
     needs neither pandas nor pyarrow: ``utils/pdpickle.py`` and
     ``data/table.py``): a. every file of ``tests/data/torch_tables``
     (EPIC-KITCHENS-100 annotations in pandas 1.x's layout and in pandas
     3's with pyarrow strings, EPIC-Sounds ones with object columns,
     feature-time and video-info tables, a ``.pkl.gz``, the finetune CSV)
     read and held to its ``.npz`` twin (columns, index, numbers bit for
     bit; bytes and read seconds); b. seeded npy banks at the CLI's EPIC
     widths, then ``cli.main --variant detection --train --validate`` (one
     epoch, bf16, batch 64, banked, full width and depth) on the files;
     c. the same flags through ``cli.run`` on splits the port built from
     the twins: train losses, validation statistics and weights bit-equal;
     d. ``cli.main --extract_feats --extract_top_k 8`` and the ``evals``
     main on that dump against the EPIC-100 validation pickle (verb mAP;
     random weights); e. ``cli.main --variant recognition --validate``;
     f. ``extract.cli.main --backbone slowfast --audio_dir`` over the
     fixture's 60 s video (a wav from ``scipy.io.wavfile``), its bank
     bit-equal to phase 20's direct route; g. neither pandas nor pyarrow
     loaded. Kernel 1 six times a detection validation or dump batch,
     once a layer a recognition batch; the phase's seconds (limit 60).
 28. ``--audio_hdf5`` without h5py (after 27; ``utils/hdf5.py``): a. every
     dataset of ``tests/data/torch_hdf5`` (h5py's default format with a
     two-level root B-tree, the earliest and latest formats: filters,
     compact, fill values, the five chunk indexes, compact and dense
     groups) read and held to its ``.npz`` twin bit for bit (seconds,
     MB/s); b. ``extract.cli.main --backbone slowfast --audio_hdf5`` over
     its three EPIC-named waveforms at full width (fp32, ``--num_aug 2``),
     each bank bit-equal to the ``--audio_dir`` route over float32 WAVs of
     the twins' samples under the same ``random.seed`` (the routes in
     turns, hdf5, wav, wav, hdf5: wall clips/s of each run; launches of
     path ``hdf5-audio``, its first run: 0 of each kernel); c. a
     flipped byte in a dataset's ``OHDR`` and the file cut inside a
     waveform refused, the structure named; d. h5py never loaded; the
     phase within 30 s.
 29. JPEG frames without PIL or cv2 (after 28; ``utils/jpeg.py`` over
     ``csrc/host/jpeg.cc``, built with g++, and ``extract/image.py``): a.
     every file of ``tests/data/torch_jpeg`` decoded without and with the
     Exif orientation and both uint8 resizes (Pillow's BILINEAR, cv2's
     INTER_LINEAR) of the first decode held to its ``.npz`` twin (SHA-256
     of Pillow's and cv2's outputs) bit for bit; decode and resize
     frames/s of the EPIC frames; b.
     ``extract.cli.main --backbone omnivore`` and ``--backbone videomae``
     (full-width Swin-B and ViT-L, bf16, ``--num_aug 1``, batch 4) over the
     fixture's two EPIC frame directories (456 x 256, 4:2:0), twice each,
     every bank bit-equal to ``extract_features_for_video`` over the
     twin-checked decodes through the port's transforms; wall clips/s;
     launches of paths ``jpeg-extract-omnivore`` (kernel 4, 24 a forward)
     and ``jpeg-extract-videomae`` (kernel 5, 24 a forward); c.
     ``jpeg_frame_reader`` + ``EK100ClipDataset(mode="validation")`` clips
     bit-equal to the twins' route; d. a truncated frame and a flipped
     byte inside its scan refused with the offset named; neither PIL nor
     cv2 loaded in a-d; e. where the machine has PIL and cv2, in a
     subprocess: their decodes and resizes of every file against the
     port's, cv2's row tails over a grid of widths (any mismatch fails),
     and PIL's, cv2's and the port's frames/s side by side; the phase
     within 40 s.
 30. RandAugment without PIL (after 29, on its decodes, host library and
     backbones; ``extract/imageops.py``, its affine resample and SMOOTH
     filter in ``csrc/host/imageops.cc``): a. every case of
     ``tests/data/torch_autoaug`` (each op name at magnitudes 0, 5, 10 and
     a draw of 7 with std 0.5, the geometric ops at NEAREST, BILINEAR and
     BICUBIC with two fills, on three EPIC frames and two odd ones; the
     clip front doors ``omnivore_clip_augment`` of 32 frames and
     ``VideoRandAugment`` of 16) held to the SHA-256 of Pillow's result;
     each C++ loop held to its numpy twin; frames/s of the point, enhance
     and bicubic affine ops; b. ``extract.cli.main --num_aug 2`` for Swin-B
     and ViT-L (full width, bf16, batch 4) over the EPIC frame
     directories: set 0 bit-equal to phase 29's banks, set 1 to
     ``extract_features_for_video`` over the decodes augmented by the numpy
     twins under the same seeds; wall clips/s; launches of paths
     ``autoaug-extract-omnivore`` (kernel 4, 24 a forward) and
     ``autoaug-extract-videomae`` (kernel 5, 24 a forward); c. an
     ``EK100ClipDataset(mode="train")`` item through ``jpeg_frame_reader``
     and the default ``VideoRandAugment`` bit-equal to the numpy twins'
     route; d. a fixture output and a bank with one byte changed refused;
     PIL and cv2 blocked in a-d; e. where the machine has PIL, in a
     subprocess: Pillow's ops against the port's over the fixture's grid
     and a seeded random grid (any mismatch fails), Pillow's and the
     port's frames/s side by side; the phase within 40 s.
 31. the widths the command lines take past the presets (last): a. kernel
     5 and 5b at [8, 16, 1568, dh] for VideoMAE's dh 80, 88 and 128 and at
     [2, 16, 1568, 104] (bf16: the wgmma instances 80, 96, 112 and 128
     reading q, k and v in place, shown by their route counts; the
     backward bit-equal call to call and to its deterministic route) and
     at [2, 16, 1568, 91] (the zero-padded copy to the 96 instance),
     kernel 1 at the
     wide TIM's [128, 16, 798, 160] (F 100, bf16 on its tensor-core
     instance) and at head dim 91 on strided views of a packed qkv,
     kernel 2 at [128 x 898, 2560] FF 5120 and [128 x 898, 728] FF 1456,
     kernel 3 at fc_action's [51,072 x 2560] -> 3806 (two chunks of K),
     K 728 (w_q padded once) and K 726 (x's rows unaligned), each in fp32
     and bf16 against its plain version under the gates in force, each
     bf16 gate shown to reject its controls, the bf16 calls timed beside
     the plain version, the library call (SDPA and its backward, masked
     SDPA, the unfused tail, quantize + ``_int_mm``) and the bound, with
     their launches; b. TIM detection at ``--d_model 1280 --nhead 16``
     (C 2560): an fp32 2-layer slice card vs CPU, then 6 layers on the
     card, bf16 vs fp32 scores, one bf16 batch of 128 windows (kernels 1
     and 2, paths ``widths-tim-wide-bf16``) and int8 static serving with
     the fused heads (kernels 1 and 3, ``widths-tim-wide-int8``); the
     same at ``--d_model 364 --nhead 8`` (C 728, head dim 91) at 2 layers
     (``widths-tim-odd-*``); c. ``finetune_cli.run --mode finetune`` at
     ViT-H/16 (``--embed_dim 1280 --depth 32 --num_heads 16``: 32
     launches of kernels 5 and 5b a step, all on their 80 instances with
     no copy, ``widths-vit-h``), two steps of 8 clips and one validation
     batch; peak memory, seconds and device ms a step.
 31d. Head dims past 256 (phase "heads", after 31): kernels 1, 5 and 5b
     on their column-slice routes (``csrc/*_cols.cu``), kernel 1 at
     [128, H, 798, dh] F 100 for (H, dh) (2, 512), (1, 1024) and (3, 300:
     the copy to 320), kernels 5 / 5b at [8, 2, 1568, 512], [8, 1, 1568,
     1024] and [2, 3, 1568, 320], fp32 at a smaller batch, on strided views
     of a packed projection, under 31a's gates and controls, the bf16
     calls timed beside SDPA (its backend named); TIM detection at
     ``--d_model 512 --nhead 2`` (6 layers, ``widths-tim-h2-*``),
     ``--nhead 1`` and ``--d_model 450 --nhead 3`` (2 layers,
     ``widths-tim-h1-*``, ``widths-tim-h3-*``) as in b; ``cli.run --train
     --validate`` and a resumed ``--validate`` at ``--nhead 2``
     (``widths-cli-h2-*``); ``finetune_cli.run --mode finetune`` at
     ``--embed_dim 1024 --depth 24 --num_heads 2`` (``widths-vit-l-h2``)
     as in c. Every launch of kernels 1, 5 and 5b on these paths counts on
     a column-slice route.
The counts are set to 0 just before each serving, extraction or training
run and read just after it (the bias epilogue's count must be the same in
every forward or step of a run, and not 0). Each phase's wall seconds are printed after it,
and all of them on one ``[time]`` line at the end. The line before the last is the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

T_START = time.perf_counter()

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# Random heads give scores whose spread no fixed threshold fits: the serving
# phases threshold at the score that about this many candidates clear,
# read off the 2-window run (keeps Soft-NMS to seconds).
TARGET_CANDIDATES = 5000
# Kernel 1 in bf16 is held to attention_close (scaled to its output), the
# others to kernel_close with these bounds.
TOL = {("query_block_attention", "float32"): 1e-4,
       ("fused_post_attention", "float32"): 2e-4,
       ("fused_post_attention", "bfloat16"): 5e-2}
# Kernel 2 in bf16 is also held to ||got - want|| / ||want||: the flat
# bound alone passes a tail without b2 (b2 ~ 0.02 moves z by < 2 spacings
# and 1.2e-2 relative RMS); the same function summed in another order
# differs only where a bf16 rounding flips
FUSED_BF16_REL_RMS = 5e-3
SLICE_TOL = 1e-3         # fp32 card vs fp32 CPU, whole slice
# kernels 4 and 5 vs their plain versions: fp32 sums in another order
# (1e-4 elementwise); bf16 scaled to the output (see attention_close)
ATTN_F32_TOL = 1e-4
ATTN_BF16_FLOOR = 2.0 ** -7      # of max |want|, beside two bf16 spacings
ATTN_BF16_REL_RMS = 1e-2         # ||got - want|| / ||want||
# the kernels' row log-sum-exp (natural log, about 8 at these shapes)
# against torch.logsumexp of the plain fp32 scores: fp32 sums of up to 1568
# exponentials in another order, ex2.approx (relative error 2^-22)
LSE_TOL = 1e-4
# kernel 5 checked at ViT-L's S, the MAE encoder's 160 visible tokens, a
# ragged S and the MAE decoder's 8 heads; timed at batch 8 at the main
# paths' shapes (ViT-L and the MAE encoder: 16 heads; the decoder: 8)
FLASH_CHECK_SHAPES = ((2, 16, 1568), (2, 16, 160), (3, 16, 37), (2, 8, 1568))
# the finetune CLI's ViT-L attention (phase 22: batch 8 x num_sample 2
# clips), checked in bf16 forward and backward
FT_CLI_ATTENTION = (16, 16, 1568)
FLASH_SHAPES = ((16, 1568), (16, 160), (8, 1568))
# bf16 vs fp32 backbone features, relative to the largest fp32 feature
# (measured 5.9e-3 Swin-B, 4.4e-3 ViT-L; features scaled by 0.98 fail)
BF16_FEATURE_TOL = 1.5e-2
# Swin-B stages on one 32 x 224^2 clip: (windows per clip, heads, token
# grid); N = 16 x 7 x 7 = 784 tokens per window, head dim 32
SWIN_STAGES = ((64, 4, (16, 56, 56)), (16, 8, (16, 28, 28)),
               (4, 16, (16, 14, 14)), (1, 32, (16, 7, 7)))
EXTRACT_CLIPS = 64
BF16_SCORE_TOL = 0.1     # bf16 vs fp32 sigmoid scores
# int8 vs bf16 sigmoid scores: tests/test_quant_accuracy.py's contract
INT8_SCORE_MAX, INT8_SCORE_MEAN = 0.1, 0.01
# The int8 slice amplifies float32 rounding: where the card's and the CPU's
# sums differ by an ulp, an activation may round to the neighbouring int8
# step, and with random weights such flips cascade through the 6 layers
# (a one-ulp change of the input features moves the CPU's own scores by
# ~2e-3, proposals by ~2e-2 s, calibrated scales by ~4e-3; the fp32 model
# moves 1e-7). So the int8 phases hold the card to the CPU's own spread
# under a one-ulp input change, measured in the same run: card vs CPU at
# most ULP_ENVELOPE times that spread (max and mean), or SLICE_TOL where
# the spread is below it.
ULP_ENVELOPE = 4.0
# Card rates (NVIDIA's H100 SXM data sheet, dense): device memory bytes/s
# and tensor-core operations/s by input type
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9     # replaced by nvidia-smi's clocks.max.sm in main
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_S = {}   # wall seconds of each phase, for the closing [time] line


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the phase ``name``: its wall seconds are
    logged and kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = round(time.perf_counter() - t0, 2)
    log(f"[time] {name}: {PHASE_S[name]:.2f} s")
    return out


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2):
    """(mean device ms, mean host ms to issue one call) of ``fn``: the
    calls are queued behind a spin kernel that outlasts their issue, so
    the events time the device back to back whatever the host's speed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_ms = 20.0
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(int(spin_ms * 1e-3 * SM_CLOCK_HZ))
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters, host_ms / iters
        spin_ms *= 4


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of ``kind``."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                          "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_spacing(want):
    mag = want.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_close(got, want, tol: float) -> bool:
    """Every |got - want| <= tol; for bf16 outputs, <= max(tol, two bf16
    spacings at |want|). Two correct implementations that sum in different
    orders flip bf16 roundings, and a flip carried through LN2 reaches two
    spacings, 0.0625 at |z| in [4, 8), about once in 10^7 outputs (seen on
    the card at batch 16 and 64), so a flat 5e-2 cannot hold at serving
    sizes; below |z| = 4 the flat bound is the binding one."""
    err = (got.float() - want.float()).abs()
    bound_ = torch.full_like(err, tol)
    if got.dtype == torch.bfloat16:
        bound_ = torch.maximum(bound_, 2 * bf16_spacing(want))
    return bool((err <= bound_).all())


def fused_close(got, want):
    """Kernel 2 against its plain version: (ok, max abs error, relative RMS
    error); kernel_close with TOL, and in bf16 also the relative RMS
    within FUSED_BF16_REL_RMS."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    dtype = str(got.dtype).split(".")[1]
    ok = kernel_close(got, want, TOL[("fused_post_attention", dtype)])
    if got.dtype == torch.bfloat16:
        ok = ok and rel <= FUSED_BF16_REL_RMS
    return ok, err.max().item(), rel


def tail_with_ln2_over_half(x, attn, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w,
                            ln2_b):
    """A fault, kernel 2's gate's control: the plain tail with LN2's
    statistics taken over the first half of each row only."""
    from tim_tpu_torch.ops import fused_post_attention as fpa
    dt = x.dtype
    y = fpa.layer_norm_fp32(x + attn, ln1_w, ln1_b).to(dt)
    h = F.gelu(fpa._matmul_bias(y, w1, b1).float(),
               approximate="none").to(dt)
    s = (y + fpa._matmul_bias(h, w2, b2)).float()
    half = s[..., :s.shape[-1] // 2]
    mu = half.mean(-1, keepdim=True)
    var = torch.clamp((half * half).mean(-1, keepdim=True) - mu * mu, min=0)
    return ((s - mu) * torch.rsqrt(var + fpa.EPS) * ln2_w + ln2_b).to(dt)


def attention_close(got, want):
    """Kernels 4 and 5 against their plain versions: (ok, max abs error,
    relative RMS error). fp32: every |got - want| <= ATTN_F32_TOL. bf16:
    attention outputs are small (about sqrt(e / S) for unit-variance
    scores: 0.04 at S = 1568), so kernels 1 and 2's flat 5e-2 would pass a
    kernel that shrinks every output by 20%. Here every |got - want| <= two
    bf16 spacings at |want| plus ATTN_BF16_FLOOR * max |want|, and
    ||got - want|| / ||want|| <= ATTN_BF16_REL_RMS. The probabilities are
    rounded to bf16 before normalising in the kernel and after it in the
    plain version, which two correct kernels differ by."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    if got.dtype != torch.bfloat16:
        ok = bool((err <= ATTN_F32_TOL).all())
    else:
        floor = ATTN_BF16_FLOOR * want.float().abs().max()
        ok = (bool((err <= 2 * bf16_spacing(want) + floor).all())
              and rel <= ATTN_BF16_REL_RMS)
    return ok, err.max().item(), rel


def query_block_close(got, want):
    """Kernel 1 against its plain version: (ok, max abs error, relative RMS
    error). fp32 within TOL; bf16 by attention_close: its outputs are about
    0.1 in size, so a flat 5e-2 would pass a kernel that drops the self
    term (weight about 1 / (F + 1)), and the tensor-core kernel rounds the
    probabilities to bf16 before P V, where the plain version keeps fp32."""
    if got.dtype == torch.bfloat16:
        return attention_close(got, want)
    err = (got.float() - want.float()).abs()
    tol = TOL[("query_block_attention", "float32")]
    return (bool((err <= tol).all()), err.max().item(),
            (err.norm() / want.float().norm()).item())


def query_block_without_self(qq, kc, kq, vc, vq):
    """A fault, kernel 1's gate's control: the plain version with the self
    term's value dropped (its weight still in the denominator)."""
    scale = 1.0 / qq.shape[-1] ** 0.5
    q = qq.float() * scale
    scores = torch.matmul(q, kc.float().transpose(-1, -2))
    self_scores = (q * kq.float()).sum(-1, keepdim=True)
    m = torch.maximum(scores.amax(-1, keepdim=True), self_scores)
    e_ctx = torch.exp(scores - m)
    denom = e_ctx.sum(-1, keepdim=True) + torch.exp(self_scores - m)
    return torch.matmul(e_ctx / denom, vc.float()).to(qq.dtype)


def online_attention(s, v, tile: int = 64, rescale_sum: bool = True):
    """softmax(s) v as kernels 4 and 5 compute it, from fp32 scores s
    [..., N, N]: an online softmax over key tiles of ``tile``, the fp32
    running sum of the unnormalised probabilities, those probabilities
    rounded to v's dtype for the PV product, one rounding of the output.
    ``rescale_sum=False`` is a fault, the bf16 gate's control: the running
    sum is not rescaled when the running max grows, so outputs shrink."""
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    for j in range(0, s.shape[-1], tile):
        st = s[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = (l * corr if rescale_sum else l) + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.to(v.dtype).float() @ v[..., j:j + tile, :].float())
        m = m_new
    return (acc / l[..., None]).to(v.dtype)


def int8_close(got, want) -> bool:
    """Kernel 3 against its plain version: the int8 operands and int32 sums
    are identical, so fp32 outputs differ only by the epilogue's erf (one
    ulp; 1 + erf cancels for y < -2, hence the 1e-5 absolute floor beside
    1e-5 relative), and bf16 outputs by at most one output spacing."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool((err <= bf16_spacing(want)).all())
    return bool((err <= 1e-5 + 1e-5 * want.float().abs()).all())


def phase_linear_rounding(gen):
    """The bf16 linear on the card against its own fp32-accumulator
    reference rounded per kind (TORCH_LINEAR: fp32 sum + fp32 bias, one
    rounding; DENSE: the product rounded, then + the bf16 bias in bf16):
    bit-equal where every fp32 sum is exact (signed powers of two), and
    within a rounding flip in at most 1% of the outputs (sums in another
    order) on normal inputs at ViT-L's qkv and fc1 shapes; timed beside
    ``F.linear`` with a bf16 bias (the route before the repair)."""
    from tim_tpu_torch.models.common import DENSE, TORCH_LINEAR, linear

    def want(x, w, b, kind):
        acc = x.float() @ w.to(torch.bfloat16).float().t()
        if kind == TORCH_LINEAR:
            return (acc + b).to(torch.bfloat16)
        return acc.to(torch.bfloat16) + b.to(torch.bfloat16)

    def pow2(*shape, lo):
        e = torch.randint(lo, 1, shape, generator=gen, device="cuda")
        sign = torch.randint(-1, 2, shape, generator=gen, device="cuda")
        return torch.exp2(e.float()) * sign

    report = {}
    for kind in (TORCH_LINEAR, DENSE):
        x, w = pow2(4, 37, 64, lo=-3), pow2(96, 64, lo=-4)
        b = torch.rand(96, generator=gen, device="cuda") * 4 - 2
        got = linear(x, w, b, torch.bfloat16, rounding=kind)
        require(torch.equal(got, want(x.to(torch.bfloat16), w, b, kind)),
                f"bf16 linear ({kind}) differs from its fp32 reference on "
                f"exact sums")
        for n_out in (3072, 4096):
            x = torch.randn(8 * 1568, 1024, generator=gen,
                            device="cuda").to(torch.bfloat16)
            w = torch.randn(n_out, 1024, generator=gen, device="cuda") * 0.03
            b = torch.randn(n_out, generator=gen, device="cuda")
            got = linear(x, w, b, torch.bfloat16, rounding=kind)
            share = (got != want(x, w, b, kind)).float().mean().item()
            wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
            row = {"mismatch_share": share,
                   "ms": cuda_ms(lambda: linear(x, w, b, torch.bfloat16,
                                                rounding=kind)),
                   "previous_ms": cuda_ms(lambda: F.linear(x, wb, bb))}
            log(f"[linear] {kind} [12544, 1024] -> {n_out}: rounding flips "
                f"in {share:.2e} of the outputs; {row['ms']:.4f} ms "
                f"(previous route {row['previous_ms']:.4f} ms)")
            require(share <= 1e-2, f"bf16 linear ({kind}) differs from "
                    f"its fp32 reference in {share} of the outputs")
            report[f"{kind}_{n_out}"] = row
    return report


def check_bias_act(gen):
    """The bias epilogue kernel against its plain version at the main
    paths' shapes (ViT-L's qkv and fc1, Swin-B's stage-1 fc1 and qkv, a
    detection regression head's 2 columns), then timed at ViT-L's fc1 and
    qkv."""
    from tim_tpu_torch.ops.bias_act import bias_act, bias_act_plain
    worst = 0.0
    cases = ((8 * 1568, 3072, torch.float32, False),
             (8 * 1568, 4096, torch.bfloat16, True),
             (8 * 16 * 56 * 56, 512, torch.bfloat16, True),
             (8 * 16 * 56 * 56, 384, torch.bfloat16, False),
             (8 * 1568, 4096, torch.float32, True),
             (4 * 399, 2, torch.float32, False),
             (37, 12, torch.bfloat16, True))
    for rows, cols, dtype, gelu in cases:
        y = (torch.randn(rows, cols, generator=gen, device="cuda") * 3).to(
            dtype)
        b = torch.randn(cols, generator=gen, device="cuda")
        got, pre = bias_act(y, b, gelu=gelu, keep_pre=True)
        torch.cuda.synchronize()
        want, h = bias_act_plain(y, b, gelu=gelu)
        err = max_err(got, want)
        flips = (got != want).float().mean().item()
        tag = (f"[{rows}, {cols}] {str(dtype)[6:]} in"
               f"{' + GELU' if gelu else ''}")
        log(f"[linear] bias_act {tag}: max_abs_err={err:.3e}, "
            f"{flips:.2e} of the outputs differ")
        # bit-equal, the GELU included: JAX's bf16 steps on both sides,
        # erfc from the same CUDA library
        require(torch.equal(got, want) and (pre is None or torch.equal(pre, h)),
                f"bias_act {tag} disagrees with its plain version")
        worst = max(worst, err)
    rows, cols = 8 * 1568, 4096
    y = torch.randn(rows, cols, generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn(cols, generator=gen, device="cuda")
    ms_bound, by = bound(nbytes(y, b) + rows * cols * 2, 0, "bf16")
    report = {"max_abs_err": worst,
              "ms": cuda_ms(lambda: bias_act(y, b, gelu=True)),
              "plain_ms": cuda_ms(lambda: bias_act_plain(y, b, gelu=True)),
              "library_ms": None, "bound_ms": ms_bound, "bound_by": by}
    y32 = torch.randn(rows, 3072, generator=gen, device="cuda")
    b32 = torch.randn(3072, generator=gen, device="cuda")
    report["fp32_in_ms"] = cuda_ms(lambda: bias_act(y32, b32, gelu=False))
    fp32_in_bound = bound(nbytes(y32, b32) + rows * 3072 * 2, 0, "bf16")[0]
    log(f"[linear] bias_act [{rows}, {cols}] bf16 + GELU (ViT-L fc1): "
        f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
        f"bound {ms_bound:.4f} ms ({by}); fp32 in [{rows}, 3072] (ViT-L "
        f"qkv) {report['fp32_in_ms']:.4f} ms, bound "
        f"{fp32_in_bound:.4f} ms")
    return report


def qkv_views(batch, dtype, gen):
    """q/k/v of one layer as the model hands them to attention: strided
    [B, H, S, dh] views of one packed projection."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models.queries import generate_query_pyramid
    cfg = C.epic_detection()
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    s = cfg.num_context + 2 * nq
    width, heads = cfg.encoder_width, cfg.nhead
    qkv = torch.randn(batch, s, 3 * width, generator=gen, device="cuda")
    q, k, v = qkv.to(dtype).view(batch, s, 3, heads, width // heads).permute(
        2, 0, 3, 1, 4)
    f = cfg.num_context
    return (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])


def tail_args(batch, dtype, gen, seq=898, c=1024, ff=2048):
    """Inputs of one encoder layer's post-attention tail (the detection
    layer's shapes by default)."""

    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * bound

    x = torch.randn(batch, seq, c, generator=gen, device="cuda").to(dtype)
    attn = torch.randn(batch, seq, c, generator=gen, device="cuda").to(dtype)
    return (x, attn, 1 + u(c, bound=0.5), u(c, bound=0.1),
            u(ff, c, bound=c ** -0.5), u(ff, bound=c ** -0.5),
            u(c, ff, bound=ff ** -0.5), u(c, bound=ff ** -0.5),
            1 + u(c, bound=0.5), u(c, bound=0.1))


def unfused_tail(x, attn, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """What EncoderLayer runs with use_fused_ffn=False: library bf16 GEMMs
    and separate LN/GELU/residual passes. Timed beside the kernel, since the
    plain version's products run in fp32."""
    from tim_tpu_torch.models.common import TORCH_LINEAR, linear
    from tim_tpu_torch.ops.fused_post_attention import layer_norm_fp32
    dt = x.dtype
    y = layer_norm_fp32(x + attn, ln1_w, ln1_b).to(dt)
    h = linear(linear(y, w1, b1, dt, rounding=TORCH_LINEAR, gelu=True), w2,
               b2, dt, rounding=TORCH_LINEAR)
    return layer_norm_fp32(y + h, ln2_w, ln2_b).to(dt)


def masked_sdpa_args(qq, kc, kq, vc, vq):
    """The query block as one library attention call: keys [kc || kq],
    values [vc || vq], a boolean mask allowing every context key and the
    query's own key."""
    nq, f = qq.shape[2], kc.shape[2]
    mask = torch.zeros(nq, f + nq, dtype=torch.bool, device=qq.device)
    mask[:, :f] = True
    mask[:, f:] = torch.eye(nq, dtype=torch.bool, device=qq.device)
    return qq, torch.cat([kc, kq], 2), torch.cat([vc, vq], 2), mask


def int8_head_args(batch, n, dtype, gen, *, bias=True, seq=898,
                   rows=(100, 499), k=1024):
    """Inputs of one int8 class head as the model hands them over: x the
    strided [B, rows, K] query slice of a [B, seq, K] encoder output, w_q
    [N, K] int8, per-channel scales that keep y near unit size, a static
    activation scale from x's abs-max."""
    x = torch.randn(batch, seq, k, generator=gen, device="cuda").to(dtype)
    xv = x[:, rows[0]:rows[1]]
    w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * 3e-4
    b = (torch.randn(n, generator=gen, device="cuda") * 0.1 if bias
         else None)
    act_scale = xv.float().abs().amax().item() / 127.0
    return xv, w_q, w_scale, act_scale, b


def int8_library_route(x, w_q_padded, w_scale, act_scale, bias, n):
    """Kernel 3's function from library calls: quantize, ``torch._int_mm``
    over N padded to a multiple of 8, dequantize + bias epilogue."""
    from tim_tpu_torch.ops.int8_matmul_fused import _scales
    inv_sx, sx = _scales(act_scale)
    x2 = x.reshape(-1, x.shape[-1]).float()
    xq = torch.clamp(torch.round(x2 * inv_sx), -127, 127).to(torch.int8)
    acc = torch._int_mm(xq, w_q_padded.t())[:, :n]
    return (acc.float() * (sx * w_scale) + bias).to(x.dtype)


def phase_kernels():
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import query_block_attention as qba

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = {
        "query_block_attention": (qba.query_block_attention,
                                  qba.query_block_attention_plain, qkv_views),
        "fused_post_attention": (fpa.fused_post_attention,
                                 fpa.fused_post_attention_plain, tail_args),
    }

    def close(name, got, want):
        """(ok, max abs error, description of the bound)"""
        if name == "query_block_attention":
            ok, err, rel = query_block_close(got, want)
            return ok, err, (f"relative RMS {rel:.3e}; attention_close"
                             if got.dtype == torch.bfloat16
                             else f"tol {TOL[(name, 'float32')]}")
        tol = TOL[(name, str(got.dtype).split(".")[1])]
        ok, err, rel = fused_close(got, want)
        return ok, err, (f"tol {tol}, relative RMS {rel:.3e}"
                         + (f" (<= {FUSED_BF16_REL_RMS})"
                            if got.dtype == torch.bfloat16 else ""))

    report = {}
    for name, (kernel, plain, make) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = make(16, dtype, gen)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            ok, err, how = close(name, got, want)
            log(f"[kernels] {name} {dtype} B=16: max_abs_err={err:.3e} "
                f"({how})")
            require(ok, f"{name} {dtype} disagrees with its plain version: "
                    f"max abs {err} ({how})")
        args = make(128, torch.bfloat16, gen)
        got, want = kernel(*args), plain(*args)
        ok, err, how = close(name, got, want)
        require(ok, f"{name} bf16 B=128 disagrees: max abs {err} ({how})")
        if name == "query_block_attention":
            # the gate must reject a kernel that drops the self term or
            # shrinks every output by 2%
            for cname, bad in (("self term dropped",
                                query_block_without_self(*args)),
                               ("output x 0.98",
                                (want.float() * 0.98).to(want.dtype))):
                c_ok, c_err, c_rel = query_block_close(bad, want)
                log(f"[kernels] {name} bf16 B=128 control '{cname}': max "
                    f"abs {c_err:.3e}, relative RMS {c_rel:.3e}, "
                    f"{'passes' if c_ok else 'rejected'}")
                require(not c_ok, f"{name}: the bf16 gate passes the faulty "
                        f"control '{cname}'")
                del bad
        else:
            # the gate must reject a tail without b2 and one whose LN2
            # takes its statistics over half of each row
            no_b2 = list(args)
            no_b2[7] = torch.zeros_like(args[7])
            for cname, bad in (("b2 omitted", plain(*no_b2)),
                               ("LN2 statistics over half the row",
                                tail_with_ln2_over_half(*args))):
                c_ok, c_err, c_rel = fused_close(bad, want)
                log(f"[kernels] {name} bf16 B=128 control '{cname}': max "
                    f"abs {c_err:.3e}, relative RMS {c_rel:.3e}, "
                    f"{'passes' if c_ok else 'rejected'}")
                require(not c_ok, f"{name}: the bf16 gate passes the faulty "
                        f"control '{cname}'")
                del bad
            del no_b2
        out_bytes = nbytes(got)
        del got, want
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        log(f"[kernels] {name} bf16 B=128: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, max_abs_err={err:.3e}")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name == "query_block_attention":
            qq, kc = args[0], args[1]
            b, h, nq, dh = qq.shape
            f = kc.shape[2]
            # scores and weighted values over F context keys plus self
            ops = 4 * b * h * nq * (f + 1) * dh
            sdpa = masked_sdpa_args(*args)
            lib_err = max_err(F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]),
                kernel(*args))
            report[name]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
            log(f"[kernels] {name} bf16 B=128: masked "
                f"scaled_dot_product_attention {report[name]['library_ms']:.4f}"
                f" ms (max abs diff to the kernel {lib_err:.3e})")
            del sdpa
        else:
            x, w1 = args[0], args[4]
            ops = 2 * 2 * (x.numel() // x.shape[-1]) * x.shape[-1] * w1.shape[0]
            report[name]["library_ms"] = cuda_ms(lambda: unfused_tail(*args))
            # a yardstick of the product part alone: the two bare bf16
            # products through the library
            y = x.reshape(-1, x.shape[-1])
            w1b, w2b = w1.to(y.dtype), args[6].to(y.dtype)
            h = torch.matmul(y, w1b.t())
            report[name]["products_matmul_ms"] = cuda_ms(
                lambda: torch.matmul(torch.matmul(y, w1b.t()), w2b.t()))
            report[name]["product_ms"] = cuda_ms(
                lambda: torch.matmul(y, w1b.t())), cuda_ms(
                lambda: torch.matmul(h, w2b.t()))
            del y, h, w1b, w2b
            log(f"[kernels] {name} bf16 B=128: unfused library-GEMM tail "
                f"{report[name]['library_ms']:.4f} ms; the two bare bf16 "
                f"products (torch.matmul) "
                f"{report[name]['products_matmul_ms']:.4f} ms "
                f"({report[name]['product_ms'][0]:.4f} + "
                f"{report[name]['product_ms'][1]:.4f})")
        report[name]["bound_ms"], report[name]["bound_by"] = bound(
            nbytes(*args) + out_bytes, ops, "bf16")
        report[name]["share_of_bound"] = (report[name]["bound_ms"]
                                          / report[name]["ms"])
        log(f"[kernels] {name} bf16 B=128: bound "
            f"{report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}"
            f"; {100 * report[name]['share_of_bound']:.1f}% of it reached)")
        del args
        torch.cuda.empty_cache()
    report["int8_matmul_fused"] = phase_kernel_int8(gen)
    return report


def phase_kernel_int8(gen):
    """Kernel 3 against its plain version, then timed at both serving
    heads (fc_action N 3806, fc_audio N 44; 128 windows x 399 queries)
    beside the library route, its bare product (``torch._int_mm`` of
    pre-quantized rows, N padded to a multiple of 8) and a bf16
    ``F.linear``."""
    from tim_tpu_torch.ops import int8_matmul_fused as i8

    worst, cases_run = 0.0, 0
    for n in (3806, 44, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for bias, act in ((False, None), (True, None), (True, "gelu")):
                x, w_q, w_scale, sx, b = int8_head_args(3, n, dtype, gen,
                                                        bias=bias)
                cases = [("strided", x)]
                if n == 256:   # ragged 2-D rows, contiguous
                    cases.append(("2-D", x[0, :333].contiguous()))
                for layout, xin in cases:
                    got = i8.int8_matmul_fused(xin, w_q, w_scale, sx, b, act,
                                               out_dtype=dtype)
                    torch.cuda.synchronize()
                    want = i8.int8_matmul_fused_plain(
                        xin, w_q, w_scale, sx, b, act, out_dtype=dtype)
                    err = max_err(got, want)
                    worst = max(worst, err)
                    cases_run += 1
                    require(got.shape == want.shape and int8_close(got, want),
                            f"int8_matmul_fused N={n} {dtype} bias={bias} "
                            f"act={act} {layout} disagrees with its plain "
                            f"version: max abs {err}")
    log(f"[kernels] int8_matmul_fused: {cases_run} cases (N 3806/44/256, "
        f"fp32/bf16, "
        f"bias, GELU, ragged M, strided and 2-D x) agree with the plain "
        f"version, max abs err {worst:.3e}")

    seq = torch.randn(128, 898, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    shapes = []
    for head, n, rows in (("fc_action", 3806, (100, 499)),
                          ("fc_audio", 44, (499, 898))):
        x = seq[:, rows[0]:rows[1]]
        w_q = torch.randint(-127, 128, (n, 1024), generator=gen,
                            device="cuda", dtype=torch.int8)
        w_scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * 3e-4
        b = torch.randn(n, generator=gen, device="cuda") * 0.1
        sx = x.float().abs().amax().item() / 127.0
        args = (x, w_q, w_scale, sx, b)
        got = i8.int8_matmul_fused(*args)
        want = i8.int8_matmul_fused_plain(*args)
        err = max_err(got, want)
        require(int8_close(got, want), f"int8_matmul_fused {head} serving "
                f"shape disagrees: max abs {err}")
        m = x.numel() // x.shape[-1]
        ms_bound, by = bound(nbytes(x, w_q, w_scale, b, got),
                             2 * m * 1024 * n, "int8")
        del got, want
        w_pad = F.pad(w_q, (0, 0, 0, -n % 8))
        w_bf16 = (w_q.float() * w_scale[:, None]).to(torch.bfloat16)
        b_bf16 = b.to(torch.bfloat16)
        inv_sx = i8._scales(sx)[0]
        xq = torch.clamp(torch.round(x.reshape(m, 1024).float() * inv_sx),
                         -127, 127).to(torch.int8)
        row = {
            "head": head, "m": m, "k": 1024, "n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: i8.int8_matmul_fused(*args)),
            "plain_ms": cuda_ms(lambda: i8.int8_matmul_fused_plain(*args)),
            "library_ms": cuda_ms(lambda: int8_library_route(
                x, w_pad, w_scale, sx, b, n)),
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, w_pad.t())),
            "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w_bf16, b_bf16)),
            "bound_ms": ms_bound, "bound_by": by}
        log(f"[kernels] int8_matmul_fused {head} [{m} x 1024] -> {n} bf16: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library route (quantize + _int_mm + epilogue) "
            f"{row['library_ms']:.4f} ms, its bare product (_int_mm, N "
            f"{n + -n % 8}) {row['int_mm_ms']:.4f} ms, bf16 F.linear "
            f"{row['bf16_linear_ms']:.4f} ms, bound {ms_bound:.4f} ms ({by}, "
            f"{100 * ms_bound / row['ms']:.1f}% of it reached), "
            f"max_abs_err={err:.3e}")
        del xq
        shapes.append(row)
        del args
    del seq
    torch.cuda.empty_cache()
    action = shapes[0]
    return {"max_abs_err": max(worst, *(r["max_abs_err"] for r in shapes)),
            **{k: action[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
            "per_head": shapes}


def window_batch(cfg, n, rng):
    f = cfg.num_feats
    return {
        "v_feats": rng.normal(size=(n, f, cfg.visual_input_dim)),
        "a_feats": rng.normal(size=(n, f, cfg.audio_input_dim)),
        "times": np.sort(rng.uniform(0, 1, size=(n, cfg.num_context, 2)), -1),
        "window_start": np.arange(n, dtype=np.float64),
        "window_size": np.full(n, 30.0),
    }


def to_torch(batch, device):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def compare_outputs(tag, gpu_out, cpu_out, tol):
    require(sorted(gpu_out) == sorted(cpu_out), f"{tag}: output keys differ")
    for key in sorted(cpu_out):
        g, c = gpu_out[key].cpu(), cpu_out[key]
        require(tuple(g.shape) == tuple(c.shape)
                and bool(torch.isfinite(g).all()),
                f"{tag} {key}: shape {tuple(g.shape)} vs {tuple(c.shape)} "
                f"or non-finite")
        err = max_err(g, c)
        log(f"[{tag}] {key} {tuple(g.shape)}: max_abs_err={err:.3e}")
        require(err <= tol, f"{tag} {key}: card vs CPU {err} > {tol}")


def phase_slice_fp32(rng):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="float32", use_fused_ffn=True)
    t0 = time.perf_counter()
    cpu_model = TimDetection(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    # With random weights the regression heads' two sigmoids sit near one
    # constant pair, often with end < start, which the eval chain drops as
    # empty. Bias them apart so that the proposals are intervals.
    with torch.no_grad():
        for mlp in (cpu_model.reg_head.fc_visual_action,
                    cpu_model.reg_head.fc_audio_action):
            mlp[4].bias.copy_(torch.tensor([-1.0, 1.0]))
    state_dict = cpu_model.state_dict()
    gpu_model = TimDetection(cfg, device="cuda")
    gpu_model.load_state_dict(state_dict, strict=True)
    log(f"[slice-fp32] built full-width TimDetection "
        f"({sum(p.numel() for p in cpu_model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")

    batch = window_batch(cfg, 2, rng)
    gpu_out = make_inference_step(gpu_model, cfg)(to_torch(batch, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu_out = make_inference_step(cpu_model, cfg)(to_torch(batch, "cpu"))
    log(f"[slice-fp32] CPU plain forward of 2 windows: "
        f"{time.perf_counter() - t0:.2f} s")
    compare_outputs("slice-fp32", gpu_out, cpu_out, SLICE_TOL)
    return state_dict, batch, gpu_out


def synthetic_video(cfg, rng):
    """~300 s video, a feature every 0.2 s, feat_stride 3 (30 s windows)."""
    duration, gap = 300.0, 0.2
    steps = int(duration / gap)
    starts = (np.arange(steps) * gap).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.0], -1)
    v = rng.normal(size=(steps, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(steps, cfg.audio_input_dim)).astype(np.float32)
    return v, a, feat_times, duration


class RouteCount:
    """The launches of some of a kernel wrapper's routes (its ``routes``
    counts, named by ``ops.flash_mha.route`` / ``query_block_attention.
    route``): those in ``names``, or those ``match`` accepts; read and set
    to 0 as a wrapper's ``launches`` count is."""

    def __init__(self, fn, names=(), match=None):
        self.fn, self.names, self.match = fn, tuple(names), match

    def _keys(self):
        return [n for n in self.fn.routes
                if n in self.names or (self.match and self.match(n))]

    @property
    def launches(self) -> int:
        return sum(self.fn.routes[n] for n in self._keys())

    @launches.setter
    def launches(self, value: int) -> None:
        require(value == 0, f"a route count is only set to 0, not {value}")
        for n in self._keys():
            self.fn.routes.pop(n, None)


def sliced(route: str) -> bool:
    """Whether a route name is one of the column-slice routes (head dims
    past 256)."""
    return " slices " in route


# counts that are a part of another kernel's (kernel 5 / 5b's routes at
# head dims 65-128, the sources flash_mha_wide.cu / flash_mha_bwd_wide.cu;
# kernels 1, 5 and 5b past 256, the *_cols.cu sources; kernels 4 / 4b past
# head dim 32, the window_attention_*.cu sources)
ROUTE_COUNTS = ("flash_mha_wide", "flash_mha_bwd_wide",
                "query_block_attention_cols", "flash_mha_cols",
                "flash_mha_bwd_cols", "window_attention_wide",
                "window_attention_256", "window_attention_f32",
                "window_attention_cols", "window_attention_bwd_wide",
                "window_attention_bwd_f32", "window_attention_bwd_cols",
                "window_attention_dbias")


def window_route_counts():
    """Kernel 4 / 4b's route counts past head dim 32, by source."""
    from tim_tpu_torch.ops import window_attention as wa
    bf16, f32 = torch.bfloat16, torch.float32

    def names(dtype, dims, backward=False):
        return [wa.route(dtype, w, c, backward=backward) for w in dims
                for c in (False, True)]
    fwd, bwd = wa.window_attention, wa.window_attention_bwd
    return {
        "window_attention_wide": RouteCount(fwd, names(bf16, (64, 80, 96,
                                                              112))),
        "window_attention_256": RouteCount(fwd, names(bf16, (128, 256))),
        "window_attention_f32": RouteCount(fwd, names(f32, (64, 128, 256))),
        "window_attention_cols": RouteCount(fwd, match=sliced),
        "window_attention_bwd_wide": RouteCount(
            bwd, names(bf16, (64, 80, 96, 112, 128), True)),
        "window_attention_bwd_f32": RouteCount(bwd, names(f32, (64,), True)),
        "window_attention_bwd_cols": RouteCount(bwd, match=sliced),
        "window_attention_dbias": RouteCount(
            bwd, match=lambda r: " + dbias pass" in r)}


def launch_counters():
    from tim_tpu_torch.ops import bias_act as ba
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.ops import window_attention as wa
    bf16 = torch.bfloat16
    return {"query_block_attention": qba.query_block_attention,
            "fused_post_attention": fpa.fused_post_attention,
            "int8_matmul_fused": i8.int8_matmul_fused,
            "window_attention": wa.window_attention,
            "flash_mha": fm.flash_mha,
            "window_attention_bwd": wa.window_attention_bwd,
            "flash_mha_bwd": fm.flash_mha_bwd,
            "bias_act": ba.bias_act,
            "flash_mha_wide": RouteCount(fm.flash_mha, [
                fm.route(bf16, w, c) for w in fm.HEAD_DIMS if 64 < w < 128
                for c in (False, True)]),
            "flash_mha_bwd_wide": RouteCount(fm.flash_mha_bwd, [
                fm.route(bf16, w, c, backward=True) for w in fm.WIDE
                for c in (False, True)]),
            "query_block_attention_cols": RouteCount(
                qba.query_block_attention, match=sliced),
            "flash_mha_cols": RouteCount(fm.flash_mha, match=sliced),
            "flash_mha_bwd_cols": RouteCount(fm.flash_mha_bwd,
                                             match=sliced),
            **window_route_counts()}


def attention_launches(launches):
    """The launches of the TPU kernels' counterparts, without the bias
    epilogue of the bf16 linears (and without the route counts, which are
    parts of theirs)."""
    return sum(n for name, n in launches.items()
               if name != "bias_act" and name not in ROUTE_COUNTS)


def require_steady(tag, launches, calls):
    """The bias epilogue of the bf16 linears launched the same number of
    times, at least once, in each of ``calls`` forwards or steps."""
    n = launches["bias_act"]
    require(n > 0 and n % calls == 0, f"{tag}: bias_act launched {n} "
            f"times in {calls} calls")


def serve_run(tag, server, video, threshold):
    """One warm-up and one measured ``detect_video`` with every kernel's
    count set to 0 just before the measured call and read just after it.
    Returns (launches, batches, metrics)."""
    import tim_tpu_torch.serve as serve_mod

    v, a, feat_times, duration = video
    n_windows = len(server._window_starts(duration))
    n_batches = -(-n_windows // server.batch_size)
    counters = launch_counters()
    events, candidates = [], []
    infer = server._infer
    threshold_topk = serve_mod.threshold_predictions_topk

    def timed_infer(batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = infer(batch)
        end.record()
        events.append((start, end))
        return out

    def counting_threshold(*args, **kwargs):
        cands = threshold_topk(*args, **kwargs)
        candidates.append(sum(len(c["scores"]) for c in cands.values()))
        return cands

    server._infer = timed_infer
    serve_mod.threshold_predictions_topk = counting_threshold
    try:
        server.detect_video(v, a, feat_times, duration,
                            score_threshold=threshold)   # warm-up
        events.clear()
        candidates.clear()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = server.detect_video(v, a, feat_times, duration,
                                   score_threshold=threshold)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        serve_mod.threshold_predictions_topk = threshold_topk
        server._infer = infer

    device_ms = sum(s.elapsed_time(e) for s, e in events)
    log(f"[{tag}] {n_windows} windows in {n_batches} batches of "
        f"{server.batch_size}: device part {device_ms:.3f} ms")
    log(f"[{tag}] device windows/s {n_windows / (device_ms / 1e3):.2f} "
        f"({n_batches * server.batch_size / (device_ms / 1e3):.2f} incl. "
        f"padding)")
    log(f"[{tag}] wall windows/s {n_windows / wall:.2f} (detect_video "
        f"{wall:.3f} s)")
    log(f"[{tag}] candidates {candidates[0]}, detections "
        f"{len(dets['scores'])}, launches {launches}")
    require(len(dets["scores"]) > 0, f"{tag}: no detections")
    segs = dets["segments"]
    require(bool(np.isfinite(segs).all() and np.isfinite(dets["scores"]).all()),
            f"{tag}: non-finite detections")
    require(bool((segs[:, 1] > segs[:, 0]).all()), f"{tag}: empty segments")
    require(bool((np.diff(dets["scores"]) <= 1e-6).all()),
            f"{tag}: detections not score-sorted")
    return launches, n_batches, {
        "windows": n_windows, "batches": n_batches, "device_ms": device_ms,
        "windows_per_s": n_windows / (device_ms / 1e3), "wall_s": wall,
        "wall_windows_per_s": n_windows / wall, "candidates": candidates[0],
        "detections": len(dets["scores"])}


def require_launches(tag, launches, per_batch, n_batches):
    for name, count in per_batch.items():
        require(launches[name] == count * n_batches,
                f"{tag}: {name} launched {launches[name]} times, expected "
                f"{count} x {n_batches} batches")


def phase_serve_bf16(state_dict, batch2, fp32_out, video):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True)
    server = DetectionServer(cfg, state_dict, device="cuda",
                             batch_size=128, top_k=8)

    # bf16 vs fp32 scores on the 2 windows of the fp32 phase
    out16 = make_inference_step(server.model, cfg)(to_torch(batch2, "cuda"))
    diff = max(max_err(out16[k], fp32_out[k]) for k in ("v_scores", "a_scores"))
    log(f"[serve-bf16] bf16 vs fp32 sigmoid scores, 2 windows: max abs "
        f"diff {diff:.4e} (tol {BF16_SCORE_TOL})")
    require(diff <= BF16_SCORE_TOL, f"bf16 scores drift {diff}")
    top = torch.sort(out16["v_scores"].flatten(), descending=True).values
    n_windows_est = len(server._window_starts(video[3]))
    per_window = TARGET_CANDIDATES / n_windows_est
    threshold = top[int(per_window * len(batch2["times"]))].item()
    log(f"[serve-bf16] score threshold {threshold:.6f}: the score "
        f"{TARGET_CANDIDATES} candidates over {n_windows_est} windows would "
        f"clear if every window scored like these 2")

    launches, n_batches, metrics = serve_run("serve-bf16", server, video,
                                             threshold)
    require_launches("serve-bf16", launches,
                     {"query_block_attention": cfg.num_layers,
                      "fused_post_attention": cfg.num_layers,
                      "int8_matmul_fused": 0}, n_batches)
    metrics["bf16_vs_fp32"] = diff
    return launches, metrics, out16, threshold


def one_ulp_up(batch):
    """The batch with its feature inputs one float32 ulp larger."""
    out = dict(batch)
    for key in ("v_feats", "a_feats"):
        out[key] = batch[key] * (1 + 2.0 ** -23)
    return out


def phase_int8_slice_fp32(state_dict, batch2):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="float32", quantized_inference=True,
                           quant_pallas_heads=True)
    cpu_batch = to_torch(batch2, "cpu")
    t0 = time.perf_counter()
    server = DetectionServer.quantized(cfg, state_dict,
                                       [to_torch(batch2, "cuda")],
                                       device="cuda")
    log(f"[int8-slice-fp32] DetectionServer.quantized (quantize + calibrate "
        f"on 2 windows) on the card: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cpu_scales = [dict(DetectionServer.quantized(
        cfg, state_dict, [b], device="cpu").cfg.quant_act_scales)
        for b in (cpu_batch, one_ulp_up(cpu_batch))]
    log(f"[int8-slice-fp32] the same twice on the CPU (inputs and inputs "
        f"one ulp up): {time.perf_counter() - t0:.2f} s")
    card = dict(server.cfg.quant_act_scales)
    cpu, cpu_up = cpu_scales
    require(sorted(card) == sorted(cpu) and len(card) == 4 * cfg.num_layers + 2,
            f"calibrated layers differ: {sorted(card)} vs {sorted(cpu)}")
    rel = max(abs(card[k] - cpu[k]) / cpu[k] for k in cpu)
    spread = max(abs(cpu_up[k] - cpu[k]) / cpu[k] for k in cpu)
    log(f"[int8-slice-fp32] {len(card)} calibrated scales, card vs CPU max "
        f"relative diff {rel:.3e}; CPU vs CPU one ulp up {spread:.3e} "
        f"(limit {ULP_ENVELOPE} x that)")
    require(rel <= max(1e-6, ULP_ENVELOPE * spread),
            f"calibrated scales differ by {rel}, spread {spread}")

    # the card's model (its scales and int8 weights) on the CPU
    cpu_model = TimDetection(server.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               server.model.state_dict().items()},
                              strict=True)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    gpu_out = make_inference_step(server.model, server.cfg)(
        to_torch(batch2, "cuda"))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[int8-slice-fp32] launches {launches}")
    require(launches["int8_matmul_fused"] == 2
            and launches["fused_post_attention"] == 0,
            f"int8 fp32 slice launches {launches}")
    cpu_step = make_inference_step(cpu_model, server.cfg)
    t0 = time.perf_counter()
    cpu_out = cpu_step(cpu_batch)
    log(f"[int8-slice-fp32] CPU plain forward of 2 windows: "
        f"{time.perf_counter() - t0:.2f} s")
    cpu_up_out = cpu_step(one_ulp_up(cpu_batch))
    require(sorted(gpu_out) == sorted(cpu_out), "int8 output keys differ")
    worst = {}
    for key in sorted(cpu_out):
        g, c = gpu_out[key].cpu(), cpu_out[key]
        require(g.shape == c.shape and bool(torch.isfinite(g).all()),
                f"int8 {key}: shape {tuple(g.shape)} vs {tuple(c.shape)} "
                f"or non-finite")
        err, up = (g - c).abs(), (cpu_up_out[key] - c).abs()
        lim_max = max(SLICE_TOL, ULP_ENVELOPE * up.max().item())
        lim_mean = max(SLICE_TOL, ULP_ENVELOPE * up.mean().item())
        log(f"[int8-slice-fp32] {key} {tuple(g.shape)}: card vs CPU max "
            f"{err.max().item():.3e} mean {err.mean().item():.3e}; CPU one "
            f"ulp up max {up.max().item():.3e} mean {up.mean().item():.3e}"
            f" (limits {lim_max:.3e}, {lim_mean:.3e})")
        require(err.max().item() <= lim_max
                and err.mean().item() <= lim_mean,
                f"int8 {key}: card vs CPU beyond the one-ulp envelope")
        worst[key] = {"max": err.max().item(), "mean": err.mean().item(),
                      "ulp_max": up.max().item(), "ulp_mean": up.mean().item()}
    return worst, rel


def phase_serve_int8(tag, state_dict, batch2, out16, video, threshold,
                     fast_scores):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True,
                           quant_pallas_heads=True, fast_scores=fast_scores)
    t0 = time.perf_counter()
    server = DetectionServer.quantized(cfg, state_dict,
                                       [to_torch(batch2, "cuda")],
                                       device="cuda", batch_size=128,
                                       top_k=8)
    log(f"[{tag}] DetectionServer.quantized: "
        f"{time.perf_counter() - t0:.2f} s")
    out8 = make_inference_step(server.model, server.cfg)(
        to_torch(batch2, "cuda"))
    deltas = torch.cat([(out8[k] - out16[k]).abs().flatten()
                        for k in ("v_scores", "a_scores")])
    d_max, d_mean = deltas.max().item(), deltas.mean().item()
    log(f"[{tag}] int8 vs bf16 sigmoid scores, 2 windows: max abs diff "
        f"{d_max:.4e} (tol {INT8_SCORE_MAX}), mean {d_mean:.4e} "
        f"(tol {INT8_SCORE_MEAN})")
    require(d_max <= INT8_SCORE_MAX and d_mean <= INT8_SCORE_MEAN,
            f"{tag}: int8 scores drift max {d_max} mean {d_mean}")

    launches, n_batches, metrics = serve_run(tag, server, video, threshold)
    require_launches(tag, launches,
                     {"query_block_attention": 0 if fast_scores
                      else cfg.num_layers,
                      "fused_post_attention": 0, "int8_matmul_fused": 2},
                     n_batches)
    metrics.update(int8_vs_bf16_max=d_max, int8_vs_bf16_mean=d_mean)
    return launches, metrics


def swin_qkv(batch, n_win, heads, dtype, gen, n=784, dh=32):
    """q/k/v of one Swin block as the model hands them to kernel 4:
    strided [B*nW, H, N, dh] views of one packed [B*nW, N, 3, H, dh]
    projection."""
    qkv = torch.randn(batch * n_win, n, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def swin_bias(heads, dims, shifted, gen):
    """A block's relative-position bias [H, N, N] (a random table gathered
    by the real index) and region ids [nW, N] (None when unshifted)."""
    from tim_tpu_torch.models.backbones import swin3d as sw
    window, shift = sw.effective_window(dims, (16, 7, 7),
                                        (8, 3, 3) if shifted else (0, 0, 0))
    n = window[0] * window[1] * window[2]
    table = torch.randn(31 * 13 * 13, heads, generator=gen, device="cuda")
    idx = torch.from_numpy(sw.relative_position_index((16, 7, 7))[:n, :n]
                           .reshape(-1)).cuda()
    bias = table[idx].view(n, n, heads).permute(2, 0, 1).contiguous()
    region = None
    if any(shift):
        region = torch.from_numpy(sw.shift_region_ids(
            dims, window, shift)).cuda()
    return bias, region


def vit_qkv(batch, seq, dtype, gen, heads=16, dh=64):
    """q/k/v of one ViT block: strided [B, H, S, dh] views of the packed
    [B, S, 3, H, dh] projection."""
    qkv = torch.randn(batch, seq, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def check_attention(name, kernel, plain, scores, args, kw, tag,
                    controls=False):
    """The kernel's inference and training (lse) launches against the plain
    version; the row log-sum-exp against torch.logsumexp of the plain fp32
    scores (``scores``, a function of the inputs). Returns (inference
    output, max abs error). In bf16, with ``controls``, also requires that
    the gate rejects two faulty controls: the plain output scaled by 0.98,
    and the online softmax that does not rescale its running sum."""
    got = kernel(*args, **kw)
    got_lse, lse = kernel_with_lse(name)(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    s = scores(*args, **kw)
    lse_err = max_err(lse, torch.logsumexp(s, -1))
    worst = 0.0
    for launch, out in (("inference", got), ("lse", got_lse)):
        ok, err, rel = attention_close(out, want)
        log(f"[backbone-kernels] {name} {tag} {launch}: max_abs_err="
            f"{err:.3e}, relative RMS {rel:.3e}")
        require(out.shape == want.shape and ok,
                f"{name} {tag} ({launch} launch) disagrees with its plain "
                f"version: max abs {err}, relative RMS {rel}")
        worst = max(worst, err)
    log(f"[backbone-kernels] {name} {tag}: lse max_abs_err={lse_err:.3e} "
        f"(tol {LSE_TOL})")
    require(lse_err <= LSE_TOL, f"{name} {tag}: lse differs from the plain "
            f"log-sum-exp by {lse_err}")
    if controls and got.dtype == torch.bfloat16:
        bad = {"plain x 0.98": (want.float() * 0.98).to(want.dtype),
               "running sum not rescaled": online_attention(
                   s, args[2], rescale_sum=False)}
        for cname, out in bad.items():
            bad_ok, bad_err, bad_rel = attention_close(out, want)
            log(f"[backbone-kernels] {name} {tag} control '{cname}': max "
                f"abs {bad_err:.3e}, relative RMS {bad_rel:.3e}, "
                f"{'passes' if bad_ok else 'rejected'}")
            require(not bad_ok, f"{name} {tag}: the bf16 gate passes the "
                    f"faulty control '{cname}'")
    return got, worst


def kernel_with_lse(name):
    """The training launch of kernel ``name``: (output, row lse)."""
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa
    return {"flash_mha": fm.flash_mha_with_lse,
            "window_attention": wa.window_attention_with_lse}[name]


def swin_scores(q, k, v, bias, region, *, sm_scale):
    from tim_tpu_torch.ops.window_attention import window_scores
    return window_scores(q, k, bias, region, sm_scale=sm_scale)


def vit_scores(q, k, v, *, sm_scale):
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale


def window_library_args(q, k, v, bias, region, n_win):
    """Kernel 4's function as one ``scaled_dot_product_attention`` call:
    [B, nW*H, N, dh] inputs and a float mask ab[type] broadcast over the
    clips (ab as the JAX model materialises it, in q's dtype)."""
    from tim_tpu_torch.ops.window_attention import attention_bias
    bw, h, n, dh = q.shape
    shape = (bw // n_win, n_win * h, n, dh)
    ab = attention_bias(bias, region).expand(n_win, h, n, n)
    return ([t.reshape(shape) for t in (q, k, v)],
            ab.reshape(1, n_win * h, n, n).to(q.dtype))


def sdpa_with_grad(*args, **kwargs):
    """The forward of one ``scaled_dot_product_attention`` call on inputs
    that require grad: the library call that also keeps its log-sum-exp
    for the backward, beside a kernel's training launch."""
    leaves = [t.detach().requires_grad_() for t in args]

    def run():
        with torch.enable_grad():
            F.scaled_dot_product_attention(*leaves, **kwargs)
    return run


# numbers the kernels' reports carry for the log lines that are computed
# from shapes (or from another number), not measured; the kernels' JSON line
# leaves them out (its bound_ms is the one computed number it keeps)
COMPUTED = ("exp_floor_ms", "share_of_bound", "groups")


def measured(report):
    """``report`` without the COMPUTED keys, at every depth."""
    if isinstance(report, dict):
        return {k: measured(v) for k, v in report.items()
                if k not in COMPUTED}
    if isinstance(report, list):
        return [measured(v) for v in report]
    return report


def exp_floor_ms(n_scores):
    """One exponential a score on the SMs' 16-a-clock units (132 SMs) at
    the card's highest SM clock: the least time the softmax can take."""
    return n_scores / (16 * 132 * SM_CLOCK_HZ) * 1e3


def time_forward(kernel, with_lse, plain, library, library_grad, args, kw,
                 nbytes_, n_scores, dh):
    """The inference and training (lse) launches of a forward kernel at
    batch 8 beside its plain version, its library call without and with
    inputs that require grad, its bound and its exponential floor."""
    ms_bound, by = bound(nbytes_, 4 * n_scores * dh, "bf16")
    row = {}
    row["ms"], row["host_ms"] = device_ms(lambda: kernel(*args, **kw))
    row["lse_ms"], row["lse_host_ms"] = device_ms(
        lambda: with_lse(*args, **kw))
    row["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), iters=3)
    row["library_ms"], row["library_host_ms"] = device_ms(library)
    row["library_grad_ms"], _ = device_ms(library_grad)
    row.update(bound_ms=ms_bound, bound_by=by,
               exp_floor_ms=exp_floor_ms(n_scores))
    row["share_of_bound"] = ms_bound / row["ms"]
    return row


def log_forward(name, tag, row, lib_name, lib_err):
    log(f"[backbone-kernels] {name} {tag} bf16 (device ms, host ms a "
        f"call): kernel {row['ms']:.4f} ms (host {row['host_ms']:.4f}), "
        f"training launch (writes lse) {row['lse_ms']:.4f} ms (host "
        f"{row['lse_host_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
        f"{lib_name} {row['library_ms']:.4f} ms (host "
        f"{row['library_host_ms']:.4f}; max abs diff to the kernel "
        f"{lib_err:.3e}), with inputs that require grad "
        f"{row['library_grad_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{100 * row['share_of_bound']:.1f}%), exponential floor "
        f"{row['exp_floor_ms']:.4f} ms")


def phase_backbone_kernels(gen):
    """Kernels 4 and 5 (inference and training launches) against their
    plain versions, then timed at batch 8 (the extraction and training
    batch) at every shape the main paths launch."""
    from tim_tpu_torch import _build
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa

    worst = {"window_attention": 0.0, "flash_mha": 0.0}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n_win, heads, dims in SWIN_STAGES:
            for shifted in ((False, True) if n_win > 1 else (False,)):
                q, k, v = swin_qkv(1, n_win, heads, dtype, gen)
                bias, region = swin_bias(heads, dims, shifted, gen)
                _, err = check_attention(
                    "window_attention", wa.window_attention,
                    wa.window_attention_plain, swin_scores,
                    (q, k, v, bias, region), {"sm_scale": 32 ** -0.5},
                    f"{dtype} nW={n_win} H={heads} shifted={shifted} "
                    f"n_types={1 if region is None else n_win}",
                    controls=n_win == 64 and shifted)
                worst["window_attention"] = max(worst["window_attention"],
                                                err)
                cases += 1
        for b, h, s in FLASH_CHECK_SHAPES + (
                (FT_CLI_ATTENTION,) if dtype == torch.bfloat16 else ()):
            _, err = check_attention(
                "flash_mha", fm.flash_mha, fm.flash_mha_plain, vit_scores,
                vit_qkv(b, s, dtype, gen, heads=h), {"sm_scale": 0.125},
                f"{dtype} [{b}, {h}, {s}, 64]",
                controls=(b, h, s) == (2, 16, 1568))
            worst["flash_mha"] = max(worst["flash_mha"], err)
            cases += 1
    log(f"[backbone-kernels] {cases} cases (each launch) agree with the "
        f"plain versions")

    report = {}
    per_stage = []
    for n_win, heads, dims in SWIN_STAGES:
        shifted = n_win > 1
        q, k, v = swin_qkv(8, n_win, heads, torch.bfloat16, gen)
        bias, region = swin_bias(heads, dims, shifted, gen)
        args, kw = (q, k, v, bias, region), {"sm_scale": 32 ** -0.5}
        bw, h, n, dh = q.shape
        out = wa.window_attention(*args, **kw)
        torch.cuda.synchronize()
        ok, err, rel = attention_close(out, wa.window_attention_plain(*args,
                                                                     **kw))
        require(ok, f"window_attention bf16 batch 8 nW={n_win}: max abs "
                f"{err}, relative RMS {rel}")
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_kw = {"attn_mask": mask, "scale": 32 ** -0.5}
        lib_err = max_err(F.scaled_dot_product_attention(
            *lib_qkv, **lib_kw).reshape(out.shape), out)
        row = {"stage": len(per_stage) + 1, "windows": bw, "heads": h,
               "shifted": shifted, "max_abs_err": err,
               **time_forward(
                   wa.window_attention, wa.window_attention_with_lse,
                   wa.window_attention_plain,
                   lambda: F.scaled_dot_product_attention(*lib_qkv, **lib_kw),
                   sdpa_with_grad(*lib_qkv, **lib_kw), args, kw,
                   nbytes(q, k, v, bias, region, out), bw * h * n * n, dh)}
        log_forward("window_attention", f"stage {row['stage']} [{bw}, {h}, "
                    f"{n}, {dh}] shifted={shifted}", row, "masked "
                    "scaled_dot_product_attention", lib_err)
        per_stage.append(row)
        del args, lib_qkv, mask, q, k, v, out
        torch.cuda.empty_cache()
    first = per_stage[0]
    report["window_attention"] = {
        "max_abs_err": max(worst["window_attention"],
                           *(r["max_abs_err"] for r in per_stage)),
        **{key: first[key] for key in first if key.endswith(("ms", "_by"))},
        "per_stage": per_stage}

    per_shape = []
    for h, s in FLASH_SHAPES:
        q, k, v = vit_qkv(8, s, torch.bfloat16, gen, heads=h)
        kw = {"sm_scale": 0.125}
        out = fm.flash_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, rel = attention_close(out, fm.flash_mha_plain(q, k, v, **kw))
        require(ok, f"flash_mha bf16 [8, {h}, {s}, 64]: max abs {err}, "
                f"relative RMS {rel}")
        lib_err = max_err(F.scaled_dot_product_attention(q, k, v, scale=0.125),
                          out)
        row = {"shape": [8, h, s, 64], "max_abs_err": err,
               **time_forward(
                   fm.flash_mha, fm.flash_mha_with_lse, fm.flash_mha_plain,
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=0.125),
                   sdpa_with_grad(q, k, v, scale=0.125), (q, k, v), kw,
                   nbytes(q, k, v, out), 8 * h * s * s, 64)}
        # the C launcher alone (tensor maps and launch), arguments made
        # once: what of the wrapper's host time a call is not Python
        c_fn = _build.launcher("tim_flash_mha", fm._ARGTYPES)
        view, strides = fm.launch_args(q, k, v)
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                  strides, None, 8, h, s, 64, 64, 1, 0.125,
                  torch.cuda.current_stream().cuda_stream)
        _, row["launcher_host_ms"] = device_ms(lambda: c_fn(*c_args))
        log_forward("flash_mha", f"[8, {h}, {s}, 64]", row,
                    "scaled_dot_product_attention", lib_err)
        log(f"[backbone-kernels] flash_mha [8, {h}, {s}, 64]: the C "
            f"launcher alone {row['launcher_host_ms']:.4f} ms of host a "
            f"call (the wrapper {row['host_ms']:.4f})")
        per_shape.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    first = per_shape[0]
    report["flash_mha"] = {
        "max_abs_err": max(worst["flash_mha"],
                           *(r["max_abs_err"] for r in per_shape)),
        **{key: first[key] for key in first if key.endswith(("ms", "_by"))},
        "per_shape": per_shape}
    return report


BACKBONES = {
    # backbone: (factory, clip shape, kernel that its attention launches)
    "omnivore": ("omnivore_swinB_epic", (32, 224, 224, 3),
                 "window_attention"),
    "videomae": ("videomae_vit_large", (16, 224, 224, 3), "flash_mha"),
}


def backbone(name, dtype, device):
    """The backbone as ``make_visual_apply`` builds it (generator seeded
    0), in ``dtype`` on ``device``."""
    from tim_tpu_torch.models.backbones import swin3d, vit
    factory = getattr(swin3d if name == "omnivore" else vit, BACKBONES[name][0])
    return factory(dtype=dtype, device=device,
                   generator=torch.Generator().manual_seed(SEED)).eval()


def phase_backbone_slice_fp32(name, clips):
    """Full-width backbone on one clip in fp32: the card with its kernels
    against the CPU with the plain versions; the card's fp32 features of
    ``clips`` are returned for the bf16 comparison."""
    kernel = BACKBONES[name][2]
    t0 = time.perf_counter()
    cpu_model = backbone(name, "float32", "cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    log(f"[slice-{name}-fp32] built two full-width {name} backbones "
        f"({sum(p.numel() for p in cpu_model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    x = torch.from_numpy(clips)
    gpu = gpu_model(x.cuda())
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    require(launches[kernel] == 24 and sum(launches.values()) == 24,
            f"{name} fp32 forward launches {launches}, expected 24 of "
            f"{kernel}")
    t0 = time.perf_counter()
    cpu = cpu_model(x[:1])
    log(f"[slice-{name}-fp32] CPU plain forward of 1 clip: "
        f"{time.perf_counter() - t0:.2f} s")
    g = gpu[:1].cpu()
    require(g.shape == cpu.shape and bool(torch.isfinite(g).all()),
            f"{name} fp32 features: shape {tuple(g.shape)} vs "
            f"{tuple(cpu.shape)} or non-finite")
    err = max_err(g, cpu)
    log(f"[slice-{name}-fp32] features {tuple(g.shape)}: card vs CPU "
        f"max_abs_err={err:.3e} (tol {SLICE_TOL}), launches {launches}")
    require(err <= SLICE_TOL, f"{name} fp32 card vs CPU {err} > {SLICE_TOL}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return gpu.float(), err


def phase_extract(name, fp32_feats, clips):
    """``make_visual_apply`` + ``extract_features_for_video`` in bf16 over
    a synthetic video of EXTRACT_CLIPS clips at batch 8."""
    from tim_tpu_torch.extract.cli import build_parser, make_visual_apply

    frames = BACKBONES[name][1][0]
    args = build_parser().parse_args(
        ["--backbone", name, "--feature_times", "unused", "--out_dir",
         "unused", "--batch_size", "8", "--compute_dtype", "bfloat16",
         "--num_frames", str(frames)])
    t0 = time.perf_counter()
    apply_fn = make_visual_apply(args)
    log(f"[extract-{name}] make_visual_apply (random weights, seed {SEED}): "
        f"{time.perf_counter() - t0:.2f} s")
    # bf16 vs fp32 features on the 2 clips of the fp32 phase
    feats16 = apply_fn(torch.from_numpy(clips))
    rel = max_err(feats16, fp32_feats) / fp32_feats.abs().max().item()
    log(f"[extract-{name}] bf16 vs fp32 features, 2 clips: relative max "
        f"diff {rel:.4e} (tol {BF16_FEATURE_TOL})")
    require(rel <= BF16_FEATURE_TOL, f"{name} bf16 features drift {rel}")

    launches, metrics = time_extraction(f"extract-{name}", name, apply_fn)
    metrics["bf16_vs_fp32_rel"] = rel
    return launches, metrics


def time_extraction(tag, name, apply_fn):
    """``extract_features_for_video`` of EXTRACT_CLIPS synthetic clips
    through ``apply_fn`` at batch 8, after a warm-up; counts set to 0 just
    before and read just after; device (CUDA events) and wall clips/s;
    24 launches of the backbone's kernel per forward."""
    from tim_tpu_torch.extract.pipeline import extract_features_for_video

    rng = np.random.default_rng(SEED + 1)
    shape = BACKBONES[name][1]
    base = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    events = []

    class Timed:
        device = apply_fn.device

        def __call__(self, x):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = apply_fn(x)
            end.record()
            events.append((start, end))
            return out

    def clip_fn(t, a):
        return base[t % len(base)]

    timed = Timed()
    extract_features_for_video(clip_fn, 8, 1, timed, batch_size=8)  # warm-up
    events.clear()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = extract_features_for_video(clip_fn, EXTRACT_CLIPS, 1, timed,
                                      batch_size=8)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    device_ms = sum(s.elapsed_time(e) for s, e in events)
    forwards = len(events)
    kernel = BACKBONES[name][2]
    log(f"[{tag}] {EXTRACT_CLIPS} clips in {forwards} batches of 8:"
        f" device {device_ms:.3f} ms, {EXTRACT_CLIPS / (device_ms / 1e3):.2f}"
        f" device clips/s; wall {wall:.3f} s, "
        f"{EXTRACT_CLIPS / wall:.2f} wall clips/s; launches {launches}")
    require(bank.shape == (EXTRACT_CLIPS, 1, 1024)
            and bool(np.isfinite(bank).all()),
            f"{tag} bank {bank.shape} or non-finite")
    require(launches[kernel] == 24 * forwards
            and attention_launches(launches) == launches[kernel],
            f"{tag} extraction launches {launches}, expected 24 x "
            f"{forwards} of {kernel}")
    require_steady(tag, launches, forwards)
    return launches, {
        "clips": EXTRACT_CLIPS, "batches": forwards, "device_ms": device_ms,
        "device_clips_per_s": EXTRACT_CLIPS / (device_ms / 1e3),
        "wall_s": wall, "wall_clips_per_s": EXTRACT_CLIPS / wall,
        "launches_per_forward": launches[kernel] / forwards}


def phase_backbones(gen):
    """Phases 9-11; returns (kernel report, launches by path)."""
    report = timed("backbone-kernels", phase_backbone_kernels, gen)
    by_path = {}
    for name in BACKBONES:
        rng = np.random.default_rng(SEED)
        clips = rng.normal(size=(2, *BACKBONES[name][1])).astype(np.float32)
        fp32_feats, err = timed(f"slice-{name}-fp32",
                                phase_backbone_slice_fp32, name, clips)
        launches, m = timed(f"extract-{name}", phase_extract, name,
                            fp32_feats, clips)
        m["fp32_card_vs_cpu"] = err
        log(f"[extract-{name}] summary {json.dumps(m)}")
        by_path[f"extract-{name}"] = launches
        torch.cuda.empty_cache()
    return report, by_path

# Backward kernels 4b and 5b against their plain versions: fp32 within
# GRAD_F32_TOL of each gradient's largest value (sums in another order);
# bf16 as attention_close, scaled to each gradient: elementwise two bf16
# spacings + GRAD_BF16_FLOOR * max |want|, relative RMS <= GRAD_BF16_REL_RMS
# (the kernel takes D = do . o from the rounded output o, the plain version
# rowsum(dp * p); both round p and ds * scale to bf16 at the same points).
GRAD_F32_TOL = 1e-4
GRAD_BF16_FLOOR = 2.0 ** -7
GRAD_BF16_REL_RMS = 1e-2
# fp32 gradient slices, card vs CPU: of each parameter's largest gradient
GRAD_SLICE_TOL = 1e-3
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_BATCH = 2, 5, 8
# Kernel-5 shapes of the training paths: ViT-L [B, 16, 1568, 64], the MAE
# encoder's 160 visible tokens, a ragged S, the MAE decoder's 8 heads
FLASH_BWD_SHAPES = ((2, 16, 1568), (2, 16, 160), (3, 16, 37), (2, 8, 1568))


def grad_close(got, want, bf16: bool):
    """A backward kernel's output against its plain version: (ok, max abs
    error, relative RMS error); ``bf16`` names the inputs' type (dbias is
    fp32 either way)."""
    err = (got.float() - want.float()).abs()
    peak = want.float().abs().max()
    rel = (err.norm() / want.float().norm()).item()
    if not bf16:
        ok = bool((err <= GRAD_F32_TOL * peak).all())
    else:
        ok = (bool((err <= 2 * bf16_spacing(want) + GRAD_BF16_FLOOR * peak)
                   .all()) and rel <= GRAD_BF16_REL_RMS)
    return ok, err.max().item(), rel


def emulated_attention_bwd(s, q, k, v, do, *, sm_scale, drop_delta=False):
    """(dq, dk, dv, ds) as the backward kernels compute them, from fp32
    scores s [..., N, N]: the forward's output o from
    ``online_attention`` (rounded to v's dtype), D = do . o, p = exp(s -
    lse), p and ds * scale rounded to the operand type before their
    products. ``drop_delta=True`` is a fault, the gate's control: ds = p
    * dp without D."""
    o = online_attention(s, v).float()
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    do32 = do.float()
    dv = (p.to(v.dtype).float().transpose(-1, -2) @ do32).to(v.dtype)
    dp = do32 @ v.float().transpose(-1, -2)
    delta = 0.0 if drop_delta else (do32 * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dsc = (ds * sm_scale).to(q.dtype).float()
    return ((dsc @ k.float()).to(q.dtype),
            (dsc.transpose(-1, -2) @ q.float()).to(k.dtype), dv, ds)


def check_grads(name, got, want, bf16, tag):
    """Each gradient of ``got`` against ``want``; returns the worst max
    abs error."""
    worst = 0.0
    for gname, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        ok, err, rel = grad_close(g, w, bf16)
        log(f"[train-kernels] {name} {tag} {gname}: max_abs_err={err:.3e}, "
            f"relative RMS {rel:.3e} (largest |want| "
            f"{w.float().abs().max().item():.3e})")
        require(g.shape == w.shape and ok, f"{name} {tag} {gname} disagrees "
                f"with its plain version: max abs {err}, relative RMS {rel}")
        worst = max(worst, err)
    return worst


def check_controls(name, tag, want, controls):
    """The bf16 gate must reject each faulty control: (name, index of the
    gradient it replaces, its value)."""
    for cname, i, bad in controls:
        ok, err, rel = grad_close(bad, want[i], True)
        log(f"[train-kernels] {name} {tag} control '{cname}': max abs "
            f"{err:.3e}, relative RMS {rel:.3e}, "
            f"{'passes' if ok else 'rejected'}")
        require(not ok, f"{name} {tag}: the bf16 gate passes the faulty "
                f"control '{cname}'")


def flash_bwd_case(b, h, s, dtype, gen):
    from tim_tpu_torch.ops import flash_mha as fm
    q, k, v = vit_qkv(b, s, dtype, gen, heads=h)
    out, lse = fm.flash_mha_with_lse(q, k, v, sm_scale=0.125)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v), out, lse, do


def window_bwd_case(batch, n_win, heads, dims, shifted, dtype, gen):
    from tim_tpu_torch.ops import window_attention as wa
    q, k, v = swin_qkv(batch, n_win, heads, dtype, gen)
    bias, region = swin_bias(heads, dims, shifted, gen)
    out, lse = wa.window_attention_with_lse(q, k, v, bias, region,
                                            sm_scale=32 ** -0.5)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v, bias, region), out, lse, do


def sdpa_bwd_ms(q, k, v, do, mask=None):
    """Device ms of the backward of one ``scaled_dot_product_attention``
    call, through autograd (graph kept, backward repeated)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if mask is not None:
        leaves.append(mask.detach().requires_grad_())
    out = F.scaled_dot_product_attention(
        *leaves[:3], attn_mask=leaves[3] if mask is not None else None,
        scale=q.shape[-1] ** -0.5)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), iters=5)


def attention_bwd_bound(q, nbytes_):
    """5 products of 2 N^2 dh per (batch, head) at the bf16 peak, or the
    bytes at the memory rate, whichever is larger."""
    b, h, n, dh = q.shape
    return bound(nbytes_, 5 * 2 * b * h * n * n * dh, "bf16")


def deterministic_flash_bwd(args, out, lse, do):
    """Kernel 5b's route under ``torch.use_deterministic_algorithms(True)``
    (dq from the atomic-free pass): two calls bit-equal in dq, dk and dv,
    each gradient within the bf16 gate of the plain backward, dk and dv
    bit-equal to the default route's; timed beside it."""
    from tim_tpu_torch.ops import flash_mha as fm
    kw = {"sm_scale": 0.125}
    default = [g.clone() for g in fm.flash_mha_bwd(*args, out, lse, do, **kw)]
    torch.use_deterministic_algorithms(True)
    try:
        first = [g.clone() for g in fm.flash_mha_bwd(*args, out, lse, do,
                                                     **kw)]
        second = fm.flash_mha_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(first, second)]
        del second
        ms = cuda_ms(lambda: fm.flash_mha_bwd(*args, out, lse, do, **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(equal), f"flash_mha_bwd deterministic route: two calls "
            f"differ (dq, dk, dv bit-equal: {equal})")
    require(torch.equal(first[1], default[1])
            and torch.equal(first[2], default[2]),
            "flash_mha_bwd deterministic route: dk or dv differ from the "
            "default route's")
    err = check_grads("flash_mha_bwd", first,
                      fm.flash_mha_bwd_plain(*args, do, **kw), True,
                      "bf16 [8, 16, 1568, 64] deterministic route")
    log(f"[train-kernels] flash_mha_bwd deterministic route: dq, dk, dv "
        f"bit-equal between two calls; {ms:.4f} ms a call")
    return {"deterministic_ms": ms, "deterministic_max_abs_err": err}


def deterministic_window_bwd(args, out, lse, do, default):
    """Kernel 4b's route under ``torch.use_deterministic_algorithms(True)``
    (dq from the atomic-free pass): two calls bit-equal in dq, dk, dv and
    dbias, dk, dv and dbias bit-equal to the default route's ``default``,
    every gradient within the bf16 gate; timed."""
    from tim_tpu_torch.ops import window_attention as wa
    kw = {"sm_scale": 32 ** -0.5}
    torch.use_deterministic_algorithms(True)
    try:
        first = [g.clone() for g in wa.window_attention_bwd(
            *args, out, lse, do, **kw)]
        second = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(first, second)]
        del second
        ms = cuda_ms(lambda: wa.window_attention_bwd(*args, out, lse, do,
                                                     **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(equal), f"window_attention_bwd deterministic route: two "
            f"calls differ (dq, dk, dv, dbias bit-equal: {equal})")
    require(all(torch.equal(first[i], default[i]) for i in (1, 2, 3)),
            "window_attention_bwd deterministic route: dk, dv or dbias "
            "differ from the default route's")
    err = check_grads("window_attention_bwd", first,
                      wa.window_attention_bwd_plain(*args, do, **kw), True,
                      "bf16 stage 1 batch 8 deterministic route")
    log(f"[train-kernels] window_attention_bwd deterministic route: dq, dk, "
        f"dv, dbias bit-equal between two calls; {ms:.4f} ms a call")
    return {"deterministic_ms": ms, "deterministic_max_abs_err": err}


def phase_training_kernels(gen):
    """Kernels 4b and 5b against their plain backwards in fp32 and bf16,
    the bf16 gate shown to reject two faulty controls, then both timed at
    batch 8 beside the plain backward and the backward of one library
    call."""
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa

    worst = {"window_attention_bwd": 0.0, "flash_mha_bwd": 0.0}
    cases = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for n_win, heads, dims in SWIN_STAGES:
            for shifted in ((False, True) if n_win > 1 else (False,)):
                args, out, lse, do = window_bwd_case(2, n_win, heads, dims,
                                                     shifted, dtype, gen)
                tag = f"{dtype} nW={n_win} H={heads} shifted={shifted} 2 clips"
                got = wa.window_attention_bwd(*args, out, lse, do,
                                              sm_scale=32 ** -0.5)
                torch.cuda.synchronize()
                want = wa.window_attention_bwd_plain(*args, do,
                                                     sm_scale=32 ** -0.5)
                worst["window_attention_bwd"] = max(
                    worst["window_attention_bwd"],
                    check_grads("window_attention_bwd", got, want, bf16, tag))
                if bf16 and n_win == 64 and shifted:
                    s = wa.window_scores(args[0], args[1], args[3], args[4],
                                         sm_scale=32 ** -0.5)
                    bad = emulated_attention_bwd(
                        s, *args[:3], do, sm_scale=32 ** -0.5,
                        drop_delta=True)
                    ds = emulated_attention_bwd(
                        s, *args[:3], do, sm_scale=32 ** -0.5)[3]
                    # the kernel sums dbias over groups of windows
                    groups = wa.bwd_groups(*args[0].shape[:3])
                    per_group = -(-args[0].shape[0] // groups)
                    log(f"[train-kernels] window_attention_bwd {tag}: "
                        f"dbias summed over {groups} window groups")
                    check_controls("window_attention_bwd", tag, want, [
                        ("D omitted", 0, bad[0]),
                        ("dbias from one window only", 3, ds[0]),
                        ("dbias without one window group", 3,
                         ds[per_group:].sum(0))])
                    del s, bad, ds
                cases += 1
                del args, out, lse, do, got, want
        for b, h, s_len in FLASH_BWD_SHAPES + (
                (FT_CLI_ATTENTION,) if bf16 else ()):
            args, out, lse, do = flash_bwd_case(b, h, s_len, dtype, gen)
            tag = f"{dtype} [{b}, {h}, {s_len}, 64]"
            got = fm.flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
            torch.cuda.synchronize()
            want = fm.flash_mha_bwd_plain(*args, do, sm_scale=0.125)
            worst["flash_mha_bwd"] = max(
                worst["flash_mha_bwd"],
                check_grads("flash_mha_bwd", got, want, bf16, tag))
            if bf16 and (b, h, s_len) == (2, 16, 1568):
                s = vit_scores(*args, sm_scale=0.125)
                bad = emulated_attention_bwd(s, *args, do, sm_scale=0.125,
                                             drop_delta=True)
                check_controls("flash_mha_bwd", tag, want,
                               [("D omitted, dq", 0, bad[0]),
                                ("D omitted, dk", 1, bad[1])])
                del s, bad
            cases += 1
            del args, out, lse, do, got, want
    torch.cuda.empty_cache()
    log(f"[train-kernels] {cases} cases agree with the plain backwards "
        f"({time.perf_counter() - t0:.2f} s)")

    report = {}
    per_stage = []
    for n_win, heads, dims in SWIN_STAGES:
        shifted = n_win > 1
        args, out, lse, do = window_bwd_case(8, n_win, heads, dims, shifted,
                                             torch.bfloat16, gen)
        q, k, v, bias, region = args
        kw = {"sm_scale": 32 ** -0.5}
        got = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        want = wa.window_attention_bwd_plain(*args, do, **kw)
        err = check_grads("window_attention_bwd", got, want, True,
                          f"bf16 batch 8 nW={n_win}")
        ms_bound, by = attention_bwd_bound(
            q, nbytes(q, k, v, out, do, *got[:3], lse, bias, region, got[3]))
        det = (deterministic_window_bwd(args, out, lse, do, got)
               if not per_stage else {})
        del got, want
        torch.cuda.empty_cache()
        row = {"stage": len(per_stage) + 1, "windows": q.shape[0],
               "heads": heads, "shifted": shifted, "max_abs_err": err,
               "ms": cuda_ms(lambda: wa.window_attention_bwd(
                   *args, out, lse, do, **kw)),
               "plain_ms": cuda_ms(lambda: wa.window_attention_bwd_plain(
                   *args, do, **kw), iters=3, warmup=1),
               "bound_ms": ms_bound, "bound_by": by,
               "groups": wa.bwd_groups(*q.shape[:3]), **det}
        row["share_of_bound"] = ms_bound / row["ms"]
        torch.cuda.empty_cache()
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_do = do.reshape(lib_qkv[0].shape)
        try:
            row["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do, mask)
            lib = ("scaled_dot_product_attention backward with a float mask "
                   "ab[type] that requires grad")
        except RuntimeError as e:   # no backend gives the mask's gradient
            log(f"[train-kernels] SDPA cannot give dbias here: {e}")
            row["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do, mask.detach())
            lib = ("scaled_dot_product_attention backward, mask without "
                   "grad (SDPA cannot give dbias)")
        row["library"] = lib
        log(f"[train-kernels] window_attention_bwd stage {row['stage']} "
            f"[{q.shape[0]}, {heads}, 784, 32] bf16 shifted={shifted}: "
            f"kernel {row['ms']:.4f} ms ({row['groups']} window groups), "
            f"plain {row['plain_ms']:.4f} ms, {lib} "
            f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}"
            f"x), bound {ms_bound:.4f} ms ({by}; "
            f"{100 * row['share_of_bound']:.1f}% of it reached)")
        per_stage.append(row)
        del args, q, k, v, bias, region, out, lse, do, lib_qkv, mask, lib_do
        torch.cuda.empty_cache()
    first = per_stage[0]
    report["window_attention_bwd"] = {
        "max_abs_err": max(worst["window_attention_bwd"],
                           *(r["max_abs_err"] for r in per_stage)),
        **{key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "deterministic_ms")},
        "per_stage": per_stage}

    args, out, lse, do = flash_bwd_case(8, 16, 1568, torch.bfloat16, gen)
    q, k, v = args
    got = fm.flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
    torch.cuda.synchronize()
    err = check_grads("flash_mha_bwd", got,
                      fm.flash_mha_bwd_plain(*args, do, sm_scale=0.125), True,
                      "bf16 [8, 16, 1568, 64]")
    ms_bound, by = attention_bwd_bound(q, nbytes(q, k, v, out, do, *got,
                                                 lse))
    del got
    torch.cuda.empty_cache()
    report["flash_mha_bwd"] = {
        "max_abs_err": max(worst["flash_mha_bwd"], err),
        "ms": cuda_ms(lambda: fm.flash_mha_bwd(*args, out, lse, do,
                                               sm_scale=0.125)),
        "plain_ms": cuda_ms(lambda: fm.flash_mha_bwd_plain(
            *args, do, sm_scale=0.125), iters=3, warmup=1),
        "library_ms": sdpa_bwd_ms(q, k, v, do),
        "bound_ms": ms_bound, "bound_by": by}
    r = report["flash_mha_bwd"]
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    log(f"[train-kernels] flash_mha_bwd [8, 16, 1568, 64] bf16: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention backward {r['library_ms']:.4f} ms, "
        f"bound {ms_bound:.4f} ms ({by})")
    r.update(deterministic_flash_bwd(args, out, lse, do))
    del args, q, k, v, out, lse, do
    torch.cuda.empty_cache()
    return report


def train_model(kind, dtype, device, **trunk_kw):
    """A ``TwoHeadViT`` over the ViT-L or Swin-B trunk (random weights,
    generator seeded ``SEED``) in ``dtype`` on ``device``."""
    from tim_tpu_torch.models.backbones import swin3d, vit
    from tim_tpu_torch.runner.backbone import TwoHeadViT
    gen = torch.Generator().manual_seed(SEED)
    if kind == "vit":
        trunk = vit.videomae_vit_large(dtype, device=device, generator=gen,
                                       **trunk_kw)
    else:
        trunk = swin3d.omnivore_swinB_epic(dtype, device=device,
                                           generator=gen, **trunk_kw)
    return TwoHeadViT(trunk, generator=gen)


def two_head_loss(model, video, verbs, nouns):
    from tim_tpu_torch.train.backbone_finetune import (
        mixup_targets, soft_target_cross_entropy)
    perm = torch.arange(video.shape[0], device=video.device)
    lv, ln_ = model(video)
    return (soft_target_cross_entropy(lv, mixup_targets(verbs, perm, 1.0, 97))
            + soft_target_cross_entropy(ln_, mixup_targets(nouns, perm, 1.0,
                                                           300)))


def phase_grad_slice_fp32(kind, **trunk_kw):
    """One clip through a full-width, reduced-depth ``TwoHeadViT`` in fp32
    (ViT-L 2 blocks, Swin-B depths (2, 2, 2, 2); ``trunk_kw``: other trunk
    settings, such as Swin's heads): every parameter gradient on the card
    (kernels 4/5 both ways) against the CPU (plain versions)."""
    kw = {"depth": 2} if kind == "vit" else {"depths": (2, 2, 2, 2)}
    kw.update(trunk_kw)
    frames = 16 if kind == "vit" else 32
    cpu_model = train_model(kind, "float32", "cpu", **kw)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(SEED)
    clip = torch.from_numpy(rng.normal(size=(1, frames, 224, 224, 3))
                            .astype(np.float32))
    verbs, nouns = torch.tensor([3]), torch.tensor([17])
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    loss = two_head_loss(gpu_model, clip.cuda(), verbs.cuda(), nouns.cuda())
    loss.backward()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    blocks = 2 if kind == "vit" else 8
    kernel = "flash_mha" if kind == "vit" else "window_attention"
    require(launches[kernel] == blocks and launches[f"{kernel}_bwd"] == blocks
            and attention_launches(launches) == 2 * blocks,
            f"{kind} fp32 slice launches {launches}")
    t0 = time.perf_counter()
    cpu_loss = two_head_loss(cpu_model, clip, verbs, nouns)
    cpu_loss.backward()
    log(f"[grad-slice-{kind}] CPU plain forward + backward of 1 clip: "
        f"{time.perf_counter() - t0:.2f} s; loss card {loss.item():.6f}, "
        f"CPU {cpu_loss.item():.6f}; launches {launches}")
    worst, worst_name = 0.0, ""
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        g, c = p.grad.cpu(), cpu_params[name].grad
        require(bool(torch.isfinite(g).all()), f"{kind} {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"{kind} fp32 gradient {name}: card "
                f"vs CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[grad-slice-{kind}] {len(cpu_params)} parameter gradients, card "
        f"vs CPU within {worst:.3e} of each tensor's largest value (worst "
        f"{worst_name}; tol {GRAD_SLICE_TOL})")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return worst


class SyntheticClips:
    """``n`` EK100-style examples ({video, verb, noun}) cycling through 4
    random clips of ``shape`` (seeded), labels drawn once."""

    def __init__(self, n, shape, seed=SEED + 2):
        rng = np.random.default_rng(seed)
        self.base = [rng.normal(size=shape).astype(np.float32)
                     for _ in range(4)]
        self.verbs = rng.integers(0, 97, n)
        self.nouns = rng.integers(0, 300, n)

    def __len__(self):
        return len(self.verbs)

    def __getitem__(self, i):
        return {"video": self.base[i % 4], "verb": self.verbs[i],
                "noun": self.nouns[i]}


def timed_steps(owner, attr, events, losses):
    """Wrap ``owner.attr`` (a step function) so that each call records
    CUDA events around it and keeps its loss."""
    step = getattr(owner, attr)

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(*args, **kwargs)
        end.record()
        events.append((start, end))
        losses.append(metrics["loss"])
        return metrics

    setattr(owner, attr, timed)


def check_grads_finite(optimizer, flags):
    """Before each optimizer step, record whether every gradient is finite
    (a device flag; read once at the end)."""
    def hook(opt, args, kwargs):
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        norms = torch._foreach_norm(grads)
        flags.append(torch.isfinite(torch.stack(norms)).all())
    return optimizer.register_step_pre_hook(hook)


def train_run(tag, model, run, kernel, per_step, batch):
    """``run(n_steps)`` TRAIN_WARMUP times one step (gradients checked
    finite), then TRAIN_STEPS steps with every count set to 0 just before
    and read just after; the events and losses come from the step wrapper
    that ``run`` installs. Returns (launches, metrics)."""
    events, losses, flags = [], [], []
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    hook = check_grads_finite(run.optimizer(), flags)
    run(TRAIN_WARMUP, events, losses)
    torch.cuda.synchronize()
    hook.remove()
    # (the hook may run twice a step: ClippedAdamW.step calls AdamW.step)
    require(len(flags) >= TRAIN_WARMUP and bool(torch.stack(flags).all()),
            f"{tag}: non-finite gradients in the warm-up steps")
    events.clear()
    losses.clear()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(TRAIN_STEPS, events, losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    loss_values = [float(x) for x in losses]
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    log(f"[{tag}] {len(step_ms)} steps of batch {batch}: device "
        f"{ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}), "
        f"{batch / (ms / 1e3):.2f} device clips/s; wall {wall:.3f} s, "
        f"{len(step_ms) * batch / wall:.2f} wall clips/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in loss_values)}; launches {launches}")
    require(len(step_ms) == TRAIN_STEPS, f"{tag}: {len(step_ms)} steps ran")
    require(all(np.isfinite(loss_values)), f"{tag}: non-finite loss")
    n_params = len(before)
    require(moved == n_params, f"{tag}: {n_params - moved} of {n_params} "
            f"parameter tensors did not move")
    require(launches[kernel] == per_step * TRAIN_STEPS
            and launches[f"{kernel}_bwd"] == per_step * TRAIN_STEPS
            and attention_launches(launches) == 2 * per_step * TRAIN_STEPS,
            f"{tag}: launches {launches}, expected {per_step} x "
            f"{TRAIN_STEPS} of {kernel} and of {kernel}_bwd and no other "
            f"attention kernel")
    require_steady(tag, launches, TRAIN_STEPS)
    return launches, {
        "batch": batch, "steps": TRAIN_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_clips_per_s": batch / (ms / 1e3),
        "wall_s": wall, "wall_clips_per_s": TRAIN_STEPS * batch / wall,
        "peak_bytes": peak, "losses": loss_values,
        "launches_per_step": launches[kernel] / TRAIN_STEPS}


class RunnerSteps:
    """``fit`` of a runner over a dataset of ``n`` steps' worth of clips,
    its step function wrapped by ``timed_steps``."""

    def __init__(self, runner, shape, attr="train_ds"):
        self.runner, self.shape, self.attr = runner, shape, attr

    def optimizer(self):
        return self.runner.state.optimizer

    def __call__(self, n, events, losses):
        setattr(self.runner, self.attr,
                SyntheticClips(n * self.runner.batch_size, self.shape))
        self.runner.epochs = 1
        step = self.runner._step_fn
        timed_steps(self.runner, "_step_fn", events, losses)
        try:
            self.runner.fit()
        finally:
            self.runner._step_fn = step


def phase_finetune_vit():
    """``BackboneFinetuneRunner`` over full-depth ViT-L in bf16 (LLRD
    AdamW, mixup 0.8) at batch 8."""
    from tim_tpu_torch.runner.backbone import BackboneFinetuneRunner
    t0 = time.perf_counter()
    model = train_model("vit", "bfloat16", "cuda")
    built = time.perf_counter() - t0
    shape = BACKBONES["videomae"][1]
    runner = BackboneFinetuneRunner(
        model, SyntheticClips(TRAIN_BATCH * (TRAIN_WARMUP + TRAIN_STEPS),
                              shape), None,
        batch_size=TRAIN_BATCH, epochs=1, lr=1e-3, mixup_alpha=0.8,
        seed=SEED)
    runner.init_state()
    log(f"[finetune-vit] TwoHeadViT(ViT-L) bf16 "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{built:.2f} s, with its LLRD AdamW in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("finetune-vit", model, RunnerSteps(runner, shape),
                    "flash_mha", 24, TRAIN_BATCH)
    del runner, model
    torch.cuda.empty_cache()
    return out


class SwinSteps:
    """``make_two_head_step`` + AdamW(1e-4, wd 0.05), as
    ``scripts/bench_finetune_swin.py`` drives Swin-B, on batches of
    ``SyntheticClips`` moved to the card."""

    def __init__(self, model, batch):
        from tim_tpu_torch.runner.backbone import make_two_head_step
        from tim_tpu_torch.train.state import TrainState
        self.state = TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=0.05))
        self.step = make_two_head_step(model, mixup_alpha=0.8, seed=SEED)
        self.data = SyntheticClips(batch, BACKBONES["omnivore"][1])
        self.batch = batch

    def optimizer(self):
        return self.state.optimizer

    def __call__(self, n, events, losses):
        step = self.step
        timed_steps(self, "step", events, losses)
        try:
            for _ in range(n):
                items = [self.data[i] for i in range(self.batch)]
                batch = {k: torch.from_numpy(np.stack([e[k] for e in items]))
                         .cuda() for k in items[0]}
                self.step(self.state, batch)
        finally:
            self.step = step


def phase_finetune_swin():
    """Full-depth Swin-B in bf16 at batch 8 (it fits: about 24 GiB)."""
    t0 = time.perf_counter()
    model = train_model("swin", "bfloat16", "cuda")
    log(f"[finetune-swin] TwoHeadViT(Swin-B) bf16 "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("finetune-swin", model, SwinSteps(model, TRAIN_BATCH),
                    "window_attention", 24, TRAIN_BATCH)
    del model
    torch.cuda.empty_cache()
    return out


def phase_pretrain_mae():
    """``BackbonePretrainRunner`` over ``PretrainVideoMAE`` (ViT-L encoder,
    decoder 512 x 12 x 8 heads) in bf16 at batch 8, mask ratio 0.9."""
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    from tim_tpu_torch.runner.backbone import BackbonePretrainRunner
    t0 = time.perf_counter()
    model = PretrainVideoMAE(dtype="bfloat16", device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
    runner = BackbonePretrainRunner(
        model, SyntheticClips(TRAIN_BATCH, BACKBONES["videomae"][1]),
        mask_ratio=0.9, batch_size=TRAIN_BATCH, seed=SEED)
    runner.init_state()
    log(f"[pretrain-mae] PretrainVideoMAE bf16 "
        f"({sum(p.numel() for p in model.parameters())} params; "
        f"{runner.masking.total_masks} of "
        f"{int(np.prod(model.grid))} tubes masked) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("pretrain-mae", model,
                    RunnerSteps(runner, BACKBONES["videomae"][1], "dataset"),
                    "flash_mha", 36, TRAIN_BATCH)
    del runner, model
    torch.cuda.empty_cache()
    return out


def phase_training(gen):
    """Phases 12-15; returns (kernel report, launches by path)."""
    report = timed("train-kernels", phase_training_kernels, gen)
    slices = {f"finetune-{kind}": timed(f"grad-slice-{kind}",
                                        phase_grad_slice_fp32, kind)
              for kind in ("vit", "swin")}
    by_path = {}
    for path, phase in (("finetune-vit", phase_finetune_vit),
                        ("finetune-swin", phase_finetune_swin),
                        ("pretrain-mae", phase_pretrain_mae)):
        launches, metrics = timed(path, phase)
        metrics["fp32_grad_slice_rel"] = slices.get(path)
        log(f"[{path}] summary {json.dumps(metrics)}")
        by_path[path] = launches
    return report, by_path


# Phase 16: TIM detection training and validation, EPIC-KITCHENS-100
# detection at full width (d_model 512, encoder 1024, 8 heads, FFN 2048,
# 3806 + 44 classes, 2 x 399 queries, S = 898), bf16, batch 64.
DET_BATCH, DET_WARMUP, DET_STEPS = 64, 2, 5
DET_METRIC_RTOL = 1e-4     # fp32 slice, card vs CPU: losses and metrics
DET_VAL_PATHS_RTOL = 1e-3  # bf16 validation, host vs banked path
DET_VAL_BF16_RTOL = 2e-2   # bf16 vs fp32 validation losses, same weights
DET_RESUME_TOL = 1e-5      # resumed vs uninterrupted step, of each largest


def det_split(cfg, videos, rng, *, seconds=150.0, num_aug=2):
    """A synthetic detection split built from numpy alone (no pandas):
    ``videos`` videos of ``seconds`` s, a 1 s feature every 0.2 s (``num_aug``
    augmentation sets, real widths), 30 s windows at a 1 s stride (feature
    stride 3), 40 actions a video of 1-8 s; a window's GT are the actions
    fully inside it. Returns a ``DetectionDataset`` (121 windows a video)."""
    from tim_tpu_torch.data.dataset import DetectionDataset, FeatureStore
    from tim_tpu_torch.data.windows import (
        Window, WindowSet, window_feat_indices)
    size, gap, stride = 30.0, 0.2, 3
    feats = {"v": {}, "a": {}}
    times, windows = {}, []
    max_v = max_a = 0
    for i in range(videos):
        vid = f"P{i:02d}_{i:02d}"
        starts = np.arange(0.0, seconds - 1.0, gap, dtype=np.float32)
        times[vid] = np.stack([starts, starts + 1.0], -1)
        for m, dim in (("v", cfg.visual_input_dim),
                       ("a", cfg.audio_input_dim)):
            feats[m][vid] = rng.standard_normal(
                (len(starts), num_aug, dim), dtype=np.float32)
        acts = []
        for audio in (False, True):
            start = rng.uniform(0.0, seconds - 8.0, 40)
            stop = start + rng.uniform(1.0, 8.0, 40)
            labels = np.stack([
                rng.integers(0, 97, 40), rng.integers(0, 300, 40),
                rng.integers(0, cfg.visual_classes[-1], 40),
                rng.integers(0, cfg.audio_classes, 40)], -1)
            labels[:, 3 if not audio else slice(0, 3)] = -1
            acts.append((np.stack([start, stop], -1).astype(np.float32),
                         labels))
        for w in range(int(seconds - size) + 1):
            lo, hi = float(w), float(w) + size
            win = Window(video_id=vid, start_sec=lo, stop_sec=hi,
                         feat_indices=window_feat_indices(
                             times[vid], lo, hi, stride, cfg.num_feats))
            (vq, vl), (aq, al) = [
                (q[(q[:, 0] >= lo) & (q[:, 1] <= hi)],
                 lab[(q[:, 0] >= lo) & (q[:, 1] <= hi)]) for q, lab in acts]
            win.v_queries, win.v_labels = vq, vl
            win.a_queries, win.a_labels = aq, al
            max_v, max_a = max(max_v, len(vq)), max(max_a, len(aq))
            windows.append(win)
    ws = WindowSet(windows=windows, max_visual_actions=max_v,
                   max_audio_actions=max_a, num_actions=80 * videos,
                   window_size=size)
    return DetectionDataset(
        ws, FeatureStore(feats["v"], times), FeatureStore(feats["a"], times),
        dataset_name="synthetic")


def det_batch(ds, n, device):
    """The first ``n`` windows of ``ds`` as a batch of tensors on
    ``device``."""
    from tim_tpu_torch.data.dataset import batch_iterator
    batch = next(batch_iterator(ds, n, shuffle=False))
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if not k.startswith("_")}


def det_state(model, tcfg):
    from tim_tpu_torch.train.optim import make_optimizer
    from tim_tpu_torch.train.state import create_train_state
    return create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, 100, 10,
        min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
        normaliser=tcfg.normaliser_init)


def captured_grads(state):
    """{name: gradient} as the optimizer's step is about to use them."""
    grads = {}
    names = {id(p): n for n, p in state.model.named_parameters()}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.detach().clone()
    state.optimizer.register_step_pre_hook(hook)
    return grads


def phase_det_grad_slice_fp32(train_ds):
    """16a: one fp32 train step of full-width ``epic_detection`` with 2
    encoder layers (every dropout rate 0, drloc 0.3) on 2 windows, on the
    card and on the CPU with the same draws: losses and metrics, every
    parameter gradient and the normaliser."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.train.detection import make_train_step
    cfg = C.epic_detection(compute_dtype="float32", num_layers=2,
                           enc_dropout=0.0, feat_dropout=0.0,
                           seq_dropout=0.0)
    tcfg = C.TrainConfig(lambda_drloc=0.3)
    cpu_model = TimDetection(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = det_batch(train_ds, 2, "cpu")   # its augmentation sets drawn once
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = det_state(model, tcfg)
        grads = captured_grads(state)
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = make_train_step(model, cfg, tcfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        metrics = {k: v.double().cpu() for k, v in metrics.items()}
        out[dev] = (metrics, grads, float(state.normaliser),
                    {n: fn.launches for n, fn in counters.items()},
                    time.perf_counter() - t0)
    (gm, gg, gn, launches, g_s), (cm, cg, cn, _, c_s) = out["cuda"], out["cpu"]
    log(f"[det-grad-slice] fp32 step of 2 windows, 2 layers: card "
        f"{g_s:.2f} s, CPU {c_s:.2f} s; launches on the card {launches}")
    require(launches["query_block_attention"] == 0
            and launches["fused_post_attention"] == 0
            and attention_launches(launches) == 0,
            f"det fp32 train step launched {launches}")
    require(sorted(gm) == sorted(cm), "det fp32 slice: metric keys differ")
    rels = {k: abs(float(gm[k]) - float(cm[k])) / max(abs(float(cm[k])),
                                                      1e-30) for k in cm}
    for k in sorted(cm):
        log(f"[det-grad-slice] {k}: card {float(gm[k]):.8g}, CPU "
            f"{float(cm[k]):.8g} (rel {rels[k]:.2e})")
    worst_m = max(rels.values())
    require(worst_m <= DET_METRIC_RTOL, f"det fp32 slice metrics: card vs "
            f"CPU {worst_m} > {DET_METRIC_RTOL}")
    require(abs(gn - cn) <= DET_METRIC_RTOL * abs(cn) and gn != 250.0,
            f"det fp32 slice normaliser: card {gn}, CPU {cn}")
    require(sorted(gg) == sorted(cg) and len(cg) == len(list(
        cpu_model.parameters())), "det fp32 slice: gradients missing")
    worst, worst_name = 0.0, ""
    for name in cg:
        g, c = gg[name].cpu(), cg[name]
        require(bool(torch.isfinite(g).all()), f"det {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"det fp32 gradient {name}: card vs "
                f"CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[det-grad-slice] {len(cg)} parameter gradients within {worst:.3e} "
        f"of each tensor's largest value (worst {worst_name}; tol "
        f"{GRAD_SLICE_TOL}); metrics within {worst_m:.2e} (tol "
        f"{DET_METRIC_RTOL}); normaliser card {gn:.6f}, CPU {cn:.6f}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return {"grad_rel": worst, "metric_rel": worst_m}


def det_runner(cfg, train_ds, val_ds, banked):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.runner.detection import DetectionRunner
    tcfg = C.TrainConfig(batch_size=DET_BATCH, epochs=1, seed=SEED)
    runner = DetectionRunner(cfg, tcfg, train_ds, val_ds, print_freq=1000,
                             use_device_bank=banked, device="cuda")
    runner.init_state()
    return runner


def phase_det_train(train_ds, val_ds):
    """16b: ``DetectionRunner.train_epoch`` (banked: the split on the card,
    a batch a tensor of window ids) over 7 batches of 64 windows, bf16,
    every dropout on: 2 warm-up steps, then 5 timed steps with every count
    set to 0 just before them and read just after."""
    from tim_tpu_torch import config as C
    runner = det_runner(C.epic_detection(), train_ds, val_ds, True)
    require(runner._tables.num_windows // DET_BATCH == DET_WARMUP + DET_STEPS,
            f"det split of {runner._tables.num_windows} windows")
    before = [p.detach().clone() for p in runner.model.parameters()]
    counters = launch_counters()
    events, metrics, marks = [], [], {}
    step = runner._bank_step

    def timed_step(state, batch):
        if len(metrics) == DET_WARMUP:
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            marks["t0"] = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(out)
        return out

    torch.cuda.reset_peak_memory_stats()
    runner._bank_step = timed_step
    try:
        runner.train_epoch(0)
    finally:
        runner._bank_step = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events[DET_WARMUP:]]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    normaliser = float(runner.state.normaliser)
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, runner.model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    log(f"[det-train] {len(step_ms)} steps of batch {DET_BATCH}: device "
        f"{ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}), "
        f"{DET_BATCH / (ms / 1e3):.2f} device windows/s; wall {wall:.3f} s, "
        f"{DET_STEPS * DET_BATCH / wall:.2f} wall windows/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; normaliser "
        f"{normaliser:.4f}; launches {launches}")
    require(len(step_ms) == DET_STEPS, f"det-train: {len(step_ms)} steps")
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            "det-train: non-finite loss or gradient norm")
    n_params = len(before)
    require(moved == n_params, f"det-train: {n_params - moved} of "
            f"{n_params} parameter tensors did not move")
    require(normaliser != 250.0, "det-train: the normaliser stayed 250")
    require(attention_launches(launches) == 0,
            f"det-train: launches {launches}, expected no kernel 1, 2 or "
            f"other attention kernel in a train step")
    require_steady("det-train", launches, DET_STEPS)
    return runner, launches, {
        "batch": DET_BATCH, "steps": DET_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_windows_per_s": DET_BATCH / (ms / 1e3),
        "wall_s": wall, "wall_windows_per_s": DET_STEPS * DET_BATCH / wall,
        "peak_bytes": peak, "losses": losses, "grad_norms": norms,
        "normaliser": normaliser,
        "bias_act_per_step": launches["bias_act"] / DET_STEPS}


def det_validate(tag, runner):
    """``runner.validate()`` with every count set to 0 just before and read
    just after, its val steps timed by CUDA events. Returns (losses,
    launches, batches, metrics)."""
    counters = launch_counters()
    events = []
    step = runner._val_step

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        return out

    runner._val_step = timed
    try:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = runner.validate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        runner._val_step = step
    n_batches = len(events)
    windows = n_batches * DET_BATCH
    device = sum(s.elapsed_time(e) for s, e in events)
    log(f"[{tag}] {n_batches} batches of {DET_BATCH}: device {device:.3f} "
        f"ms, {windows / (device / 1e3):.2f} device windows/s; wall "
        f"{wall:.3f} s, {windows / wall:.2f} wall windows/s; losses "
        f"{json.dumps(losses)}; launches {launches}")
    require(all(np.isfinite(v) for v in losses.values()),
            f"{tag}: non-finite losses")
    return losses, launches, n_batches, {
        "batches": n_batches, "device_ms": device,
        "device_windows_per_s": windows / (device / 1e3),
        "wall_s": wall, "wall_windows_per_s": windows / wall}


def phase_det_val(runner, val_ds):
    """16c: ``validate`` of the trained weights in bf16 on the banked path
    (the runner of 16b) and on the host path, and in fp32 (host path):
    kernel 1 six times a batch, kernel 2 never; host vs banked losses;
    bf16 vs fp32 losses."""
    from tim_tpu_torch import config as C
    sd = runner.model.state_dict()
    out = {}
    for tag, cfg, banked in (
            ("det-val-banked", C.epic_detection(), True),
            ("det-val-host", C.epic_detection(), False),
            ("det-val-fp32", C.epic_detection(compute_dtype="float32"),
             False)):
        r = runner if banked else det_runner(cfg, None, val_ds, False)
        if r is not runner:
            r.load_torch_checkpoint(sd)
            r.state.normaliser = runner.state.normaliser.clone()
        losses, launches, n_batches, m = det_validate(tag, r)
        if cfg.compute_dtype == "bfloat16":
            require(launches["query_block_attention"]
                    == cfg.num_layers * n_batches
                    and launches["fused_post_attention"] == 0,
                    f"{tag}: launches {launches}, expected kernel 1 "
                    f"{cfg.num_layers} x {n_batches} batches, kernel 2 never")
            require_steady(tag, launches, n_batches)
        out[tag] = (losses, launches, m)
        if r is not runner:
            del r
            torch.cuda.empty_cache()
    banked, host, fp32 = (out[t][0] for t in (
        "det-val-banked", "det-val-host", "det-val-fp32"))
    require(sorted(banked) == sorted(host) == sorted(fp32),
            "det-val: loss keys differ")
    rel_paths = max(abs(banked[k] - host[k]) / max(abs(host[k]), 1e-30)
                    for k in host)
    rel_bf16 = max(abs(host[k] - fp32[k]) / max(abs(fp32[k]), 1e-30)
                   for k in fp32)
    log(f"[det-val] banked vs host losses within {rel_paths:.3e} (tol "
        f"{DET_VAL_PATHS_RTOL}); bf16 vs fp32 within {rel_bf16:.3e} (tol "
        f"{DET_VAL_BF16_RTOL})")
    require(rel_paths <= DET_VAL_PATHS_RTOL,
            f"det-val: banked vs host {rel_paths} > {DET_VAL_PATHS_RTOL}")
    require(rel_bf16 <= DET_VAL_BF16_RTOL,
            f"det-val: bf16 vs fp32 {rel_bf16} > {DET_VAL_BF16_RTOL}")
    metrics = {t: out[t][2] for t in out}
    metrics.update(paths_rel=rel_paths, bf16_vs_fp32_rel=rel_bf16)
    return out["det-val-banked"][1], metrics


def phase_det_resume(runner, train_ds):
    """16d: save the state after the timed steps, ``resume`` it into a
    fresh runner: step, normaliser, optimizer state and parameters equal;
    then one more step from both: parameters within DET_RESUME_TOL."""
    import tempfile
    from tim_tpu_torch import config as C
    from tim_tpu_torch.train.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, runner.state, epoch=1)
        fresh = det_runner(C.epic_detection(), train_ds, None, True)
        epoch = fresh.resume(tmp)
        io_s = time.perf_counter() - t0
    a, b = runner.state, fresh.state
    require(epoch == 1 and a.step == b.step
            and torch.equal(a.normaliser, b.normaliser),
            f"det-resume: epoch {epoch}, step {a.step} vs {b.step}, "
            f"normaliser {float(a.normaliser)} vs {float(b.normaliser)}")
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    same = all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])
    same &= all(torch.equal(sa["if_finite"][k], sb["if_finite"][k])
                for k in sa["if_finite"])
    same &= all(torch.equal(p, q) for p, q in zip(
        a.model.state_dict().values(), b.model.state_dict().values()))
    require(same and len(sa["state"]) == len(sb["state"]),
            "det-resume: optimizer state or parameters differ after resume")
    ids = torch.arange(DET_BATCH, device="cuda")
    for r in (runner, fresh):
        r._bank_step(r.state, r._tables.batch(ids))
    pairs = list(zip(a.model.parameters(), b.model.parameters()))
    worst = max(max_err(p, q) / max(p.abs().max().item(), 1e-30)
                for p, q in pairs)
    equal = sum(int(torch.equal(p, q)) for p, q in pairs)
    log(f"[det-resume] checkpoint save + resume {io_s:.2f} s; state equal "
        f"after resume; one more step from both: parameters within "
        f"{worst:.3e} of each tensor's largest value (tol {DET_RESUME_TOL}), "
        f"{equal} of {len(pairs)} tensors bit-equal")
    require(worst <= DET_RESUME_TOL, f"det-resume: {worst} > "
            f"{DET_RESUME_TOL}")
    del fresh
    torch.cuda.empty_cache()
    return {"resume_rel": worst, "save_resume_s": io_s}


def phase_detection_training():
    """Phases 16 and 18; returns the launches of the train, validation and
    mAP paths, and the splits."""
    from tim_tpu_torch import config as C
    cfg = C.epic_detection()
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    train_ds, val_ds = det_split(cfg, 4, rng), det_split(cfg, 4, rng)
    log(f"[det] synthetic splits of {len(train_ds)} and {len(val_ds)} "
        f"windows ({cfg.visual_input_dim} + {cfg.audio_input_dim} wide "
        f"features) in {time.perf_counter() - t0:.2f} s")
    summary = {"grad_slice": timed("det-grad-slice",
                                   phase_det_grad_slice_fp32, train_ds)}
    runner, train_launches, summary["train"] = timed(
        "det-train", phase_det_train, train_ds, val_ds)
    val_launches, summary["val"] = timed("det-val", phase_det_val, runner,
                                         val_ds)
    summary["resume"] = timed("det-resume", phase_det_resume, runner,
                              train_ds)
    map_launches, summary["map"] = timed("det-map", phase_det_map, runner,
                                         val_ds)
    log(f"[det] summary {json.dumps(summary)}")
    del runner
    torch.cuda.empty_cache()
    return {"det-train": train_launches, "det-val": val_launches,
            "det-map": map_launches}, (train_ds, val_ds)


# Phase 17: TIM recognition at the full width of ``epic_recognition``
# (d_model 512, encoder 1024, 8 heads of 128, 4 layers, FFN 2048, 100
# context tokens, heads 97/300/3806/44), random weights from the seed.
REC_BATCH, REC_WARMUP, REC_STEPS = 64, 2, 5
REC_INTERVALS, REC_ENSEMBLE = 200, 5
REC_SLICE_TOL = 1e-3        # fp32 logits card vs CPU, of the largest
REC_BF16_DP = 0.1           # bf16 vs fp32 serving probabilities
# int8 static vs fp32 serving: tests/test_serve.py's contract
REC_INT8_AGREE, REC_INT8_DP = 0.75, 0.25
REC_VAL_RTOL = 1e-5         # banked vs host validation statistics
REC_METRIC_RTOL = 1e-4      # fp32 train step, card vs CPU: losses
# Random class heads give near-uniform scores over 3806 classes, whose
# top-1 any rounding flips; their weights are scaled up so that the
# logits spread (std ~2) and the top-1 and agreement gates mean something.
REC_HEAD_GAIN = 4.0


def rec_split(cfg, videos, rng, *, seconds=150.0, num_aug=2, per_video=40):
    """A synthetic recognition split built from numpy alone (no pandas):
    ``videos`` videos of ``seconds`` s, a 1 s feature every 0.2 s
    (``num_aug`` augmentation sets, real widths), 30 s windows at a 1 s
    stride (feature stride 3), ``per_video`` visual and as many audio
    actions a video of 1-8 s, each with its own action id; a window's
    queries are the actions fully inside it (every action is inside one).
    Returns a ``RecognitionDataset`` (121 windows a video)."""
    from tim_tpu_torch.data.dataset import FeatureStore, RecognitionDataset
    from tim_tpu_torch.data.windows import (
        Window, WindowSet, window_feat_indices)
    size, gap, stride = 30.0, 0.2, 3
    vc = cfg.visual_classes
    feats = {"v": {}, "a": {}}
    times, windows = {}, []
    max_v = max_a = next_id = 0
    for i in range(videos):
        vid = f"P{i:02d}_{i:02d}"
        starts = np.arange(0.0, seconds - 1.0, gap, dtype=np.float32)
        times[vid] = np.stack([starts, starts + 1.0], -1)
        for m, dim in (("v", cfg.visual_input_dim),
                       ("a", cfg.audio_input_dim)):
            feats[m][vid] = rng.standard_normal(
                (len(starts), num_aug, dim), dtype=np.float32)
        acts = []
        for prefix in ("v", "a"):
            start = rng.uniform(0.0, seconds - 8.0, per_video)
            stop = start + rng.uniform(1.0, 8.0, per_video)
            labels = -np.ones((per_video, 4), np.int64)
            if prefix == "v":
                for col, n in enumerate((vc[0], vc[1], vc[-1])):
                    labels[:, col] = rng.integers(0, n, per_video)
            else:
                labels[:, 3] = rng.integers(0, cfg.audio_classes, per_video)
            ids = np.arange(next_id, next_id + per_video)
            next_id += per_video
            acts.append((prefix, np.stack([start, stop], -1).astype(
                np.float32), labels, ids))
        for w in range(int(seconds - size) + 1):
            lo, hi = float(w), float(w) + size
            win = Window(video_id=vid, start_sec=lo, stop_sec=hi,
                         feat_indices=window_feat_indices(
                             times[vid], lo, hi, stride, cfg.num_feats))
            for prefix, q, lab, ids in acts:
                inside = np.flatnonzero((q[:, 0] >= lo) & (q[:, 1] <= hi))
                setattr(win, f"{prefix}_queries", q[inside])
                setattr(win, f"{prefix}_labels", lab[inside])
                setattr(win, f"{prefix}_action_ids", ids[inside])
                setattr(win, f"{prefix}_narration_ids",
                        [f"{prefix}_{j}" for j in ids[inside]])
            max_v = max(max_v, len(win.v_queries))
            max_a = max(max_a, len(win.a_queries))
            windows.append(win)
    ws = WindowSet(windows=windows, max_visual_actions=max_v,
                   max_audio_actions=max_a, num_actions=next_id,
                   window_size=size)
    return RecognitionDataset(ws, FeatureStore(feats["v"], times),
                              FeatureStore(feats["a"], times),
                              rng=np.random.default_rng(SEED))


class EventTimed:
    """``fn`` with each call's device time recorded by CUDA events."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def device_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def zero_counts():
    """Every count set to 0, kernels 1 and 5 / 5b's route counts whole."""
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.ops import window_attention as wa
    counters = launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    fm.flash_mha.routes.clear()
    fm.flash_mha_bwd.routes.clear()
    qba.query_block_attention.routes.clear()
    wa.window_attention.routes.clear()
    wa.window_attention_bwd.routes.clear()
    return counters


def read_counts(counters):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def rec_cpu_model(cfg):
    """A full-width ``TimRecognition`` on the CPU from the seed, its class
    heads scaled by REC_HEAD_GAIN, and its state dict."""
    from tim_tpu_torch.models import TimRecognition
    model = TimRecognition(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in model.cls_head.named_parameters():
            if name.endswith("weight"):
                p.mul_(REC_HEAD_GAIN)
    return model, model.state_dict()


def rec_inputs(cfg, b, nv, na, rng, device):
    """A random forward batch (v, a, times) on ``device``."""
    f = cfg.num_feats
    v = rng.normal(size=(b, f, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(b, f, cfg.audio_input_dim)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1, (b, cfg.num_context + nv + na, 2)),
                -1).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (v, a, t))


def phase_rec_slice_fp32(rng):
    """17a: the fp32 forward of full-width ``TimRecognition`` on 2 windows
    (3 visual queries a head, 2 audio), card vs CPU, kernel 1 once a
    layer on the card; returns the state dict."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimRecognition
    cfg = C.epic_recognition(compute_dtype="float32")
    cpu_model, sd = rec_cpu_model(cfg)
    gpu_model = TimRecognition(cfg, device="cuda")
    gpu_model.load_state_dict(sd, strict=True)
    nv, na = 3, 2
    inputs = rec_inputs(cfg, 2, nv, na, rng, "cpu")
    counters = zero_counts()
    with torch.inference_mode():
        got, gctx = gpu_model(*(x.cuda() for x in inputs), nv, na)
    launches = read_counts(counters)
    with torch.inference_mode():
        want, wctx = cpu_model(*inputs, nv, na)
    require(launches["query_block_attention"] == cfg.num_layers,
            f"rec-slice-fp32: launches {launches}")
    worst = 0.0
    for name, g, w in zip(("verb", "noun", "action", "audio"), got, want):
        rel = max_err(g.cpu(), w) / w.abs().max().item()
        worst = max(worst, rel)
        log(f"[rec-slice-fp32] {name} logits {tuple(w.shape)}: card vs CPU "
            f"max abs {max_err(g.cpu(), w):.3e}, {rel:.3e} of the largest "
            f"{w.abs().max().item():.3f} (tol {REC_SLICE_TOL})")
        require(bool(torch.isfinite(g).all()) and rel <= REC_SLICE_TOL,
                f"rec-slice-fp32 {name}: {rel} > {REC_SLICE_TOL}")
    ctx_rel = max_err(gctx.cpu(), wctx) / wctx.abs().max().item()
    require(ctx_rel <= REC_SLICE_TOL, f"rec-slice-fp32 context {ctx_rel}")
    log(f"[rec-slice-fp32] context tokens within {ctx_rel:.3e}; launches "
        f"{launches}")
    return sd, {"logits_rel": worst, "context_rel": ctx_rel}


def rec_qkv_views(batch, nq, dtype, gen, f=100, heads=8, dh=128):
    """Kernel 1's inputs as a recognition layer hands them over: strided
    [B, H, S, dh] views of one packed projection of S = F + Nq tokens."""
    s, width = f + nq, heads * dh
    qkv = torch.randn(batch, s, 3 * width, generator=gen, device="cuda")
    q, k, v = qkv.to(dtype).view(batch, s, 3, heads, dh).permute(
        2, 0, 3, 1, 4)
    return (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])


def phase_rec_kernels(gen, nq_val):
    """17b: kernel 1 against its plain version at the recognition shapes:
    serving [64, 8, 4, 128] (one query a head: verb, noun, action, audio)
    and validation [64, 8, 3 nv + na, 128], fp32 and bf16 (the bf16 gate
    shown to reject the self term dropped); timed in bf16 beside the plain
    version and masked SDPA, with the bound."""
    from tim_tpu_torch.ops import query_block_attention as qba
    report = {}
    for tag, nq in (("serve", 4), ("val", nq_val)):
        for dtype in (torch.float32, torch.bfloat16):
            args = rec_qkv_views(REC_BATCH, nq, dtype, gen)
            got = qba.query_block_attention(*args)
            want = qba.query_block_attention_plain(*args)
            ok, err, rel = query_block_close(got, want)
            log(f"[rec-kernels] query_block_attention {tag} {dtype} "
                f"{tuple(got.shape)}: max_abs_err={err:.3e}, relative RMS "
                f"{rel:.3e}")
            require(ok, f"rec-kernels {tag} {dtype}: kernel 1 disagrees "
                    f"({err}, {rel})")
        c_ok, c_err, _ = query_block_close(
            query_block_without_self(*args), want)
        log(f"[rec-kernels] {tag} bf16 control 'self term dropped': max abs "
            f"{c_err:.3e}, {'passes' if c_ok else 'rejected'}")
        require(not c_ok, f"rec-kernels {tag}: the bf16 gate passes the "
                f"self term dropped")
        b, h, _, dh = args[0].shape
        f = args[1].shape[2]
        ms, host_ms = device_ms(lambda: qba.query_block_attention(*args))
        plain_ms = cuda_ms(lambda: qba.query_block_attention_plain(*args))
        sdpa = masked_sdpa_args(*args)
        library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
            sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
        bound_ms, by = bound(nbytes(*args) + nbytes(got),
                             4 * b * h * nq * (f + 1) * dh, "bf16")
        report[tag] = {"shape": [b, h, nq, dh], "max_abs_err": err,
                       "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": by}
        log(f"[rec-kernels] query_block_attention {tag} bf16 "
            f"{[b, h, nq, dh]}: kernel {ms:.4f} ms (host {host_ms:.4f} ms a "
            f"call), plain {plain_ms:.4f} ms, masked SDPA "
            f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}, "
            f"{100 * bound_ms / ms:.1f}%)")
        del args, got, want, sdpa
    return report


def rec_video(cfg, rng, n_intervals=REC_INTERVALS):
    """A ~300 s video (a feature every 0.2 s) and ``n_intervals`` random
    intervals of 1-8 s in it."""
    v, a, feat_times, duration = synthetic_video(cfg, rng)
    start = rng.uniform(0.0, duration - 9.0, n_intervals)
    intervals = np.stack([start, start + rng.uniform(1.0, 8.0, n_intervals)],
                         -1).astype(np.float32)
    return v, a, feat_times, intervals


def rec_calibration_batch(cfg, video, n, window_size=30.0):
    """(v, a, times) of the first ``n`` intervals, each in its first
    covering window, assembled as ``classify_intervals`` assembles them."""
    from tim_tpu_torch.data.windows import window_feat_indices
    v, a, feat_times, intervals = video
    vs, as_, ts = [], [], []
    for s, e in intervals[:n]:
        ws = max(0.0, float(np.ceil(max(0.0, e - window_size))))
        idx = window_feat_indices(feat_times, ws,
                                  min(ws + window_size, feat_times[-1, 1]),
                                  3, cfg.num_feats)
        t = np.concatenate([feat_times[idx, :2]] * 2
                           + [np.asarray([[s, e]], np.float32)] * 2)
        vs.append(v[idx])
        as_.append(a[idx])
        ts.append(np.clip((t - ws) / window_size, 0.0, None))
    return tuple(np.stack(x).astype(np.float32) for x in (vs, as_, ts))


def rec_serve_run(tag, server, video, per_batch):
    """A warm-up on 8 intervals, then ``classify_intervals`` over the
    video's intervals with every count set to 0 just before and read just
    after; its forwards timed by CUDA events. Returns (scores, launches,
    metrics)."""
    v, a, feat_times, intervals = video
    server.classify_intervals(v, a, feat_times, intervals[:8])
    jobs = sum(len(server._covering_windows(float(s), float(e)))
               for s, e in intervals)
    n_batches = -(-jobs // server.batch_size)
    model = server.model
    server.model = timed_model = EventTimed(model)
    try:
        counters = zero_counts()
        t0 = time.perf_counter()
        out = server.classify_intervals(v, a, feat_times, intervals)
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        server.model = model
    device = timed_model.device_ms()
    n = len(intervals)
    log(f"[{tag}] {n} intervals, {jobs} windows in {n_batches} batches of "
        f"{server.batch_size}: device {device:.3f} ms, "
        f"{n / (device / 1e3):.2f} device intervals/s; wall {wall:.3f} s, "
        f"{n / wall:.2f} wall intervals/s; launches {launches}")
    require(sorted(out) == ["action", "audio", "noun", "verb"],
            f"{tag}: heads {sorted(out)}")
    for name, p in out.items():
        require(bool(np.isfinite(p).all()) and p.shape[0] == n
                and np.allclose(p.sum(-1), 1.0, atol=1e-6),
                f"{tag} {name}: not a distribution per interval")
    require_launches(tag, launches, per_batch, n_batches)
    if server.cfg.compute_dtype == "bfloat16":
        require_steady(tag, launches, n_batches)
    return out, launches, {
        "intervals": n, "windows": jobs, "batches": n_batches,
        "device_ms": device, "device_intervals_per_s": n / (device / 1e3),
        "wall_s": wall, "wall_intervals_per_s": n / wall}


def score_agreement(got, want):
    """(top-1 agreement over every head's intervals, max |delta p|)."""
    agree = total = 0
    dp = 0.0
    for head in want:
        agree += int((got[head].argmax(-1) == want[head].argmax(-1)).sum())
        total += len(want[head])
        dp = max(dp, float(np.abs(got[head] - want[head]).max()))
    return agree / total, dp


def phase_rec_serve(sd, rng):
    """17c: ``RecognitionServer.classify_intervals`` (ensemble 5, batch 64)
    over 200 intervals of a synthetic 300 s video in fp32, bf16, int8
    static (calibrated on 16 of the intervals' windows) and bf16 with the
    fused tail (kernel 2): kernel 1 once a layer a batch on every path,
    kernel 2 only with the fused tail, kernel 3 never (int8 recognition
    heads are the static int8 linear, as in JAX); bf16 and int8 scores
    against fp32."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import RecognitionServer
    video = rec_video(C.epic_recognition(), rng)
    kw = dict(device="cuda", ensemble=REC_ENSEMBLE, batch_size=REC_BATCH)
    layers = C.epic_recognition().num_layers
    plain = {"query_block_attention": layers, "fused_post_attention": 0,
             "int8_matmul_fused": 0}
    runs, launches, metrics = {}, {}, {}
    for tag, cfg, quantized in (
            ("serve-rec-fp32", C.epic_recognition(compute_dtype="float32"),
             False),
            ("serve-rec-bf16", C.epic_recognition(), False),
            ("serve-rec-int8", C.epic_recognition(), True),
            ("serve-rec-fused", C.epic_recognition(use_fused_ffn=True),
             False)):
        t0 = time.perf_counter()
        if quantized:
            server = RecognitionServer.quantized(
                cfg, sd, [rec_calibration_batch(cfg, video, 16)], **kw)
        else:
            server = RecognitionServer(cfg, sd, **kw)
        log(f"[{tag}] server built in {time.perf_counter() - t0:.2f} s")
        per_batch = dict(plain)
        if cfg.use_fused_ffn:
            per_batch["fused_post_attention"] = layers
        runs[tag], launches[tag], metrics[tag] = rec_serve_run(
            tag, server, video, per_batch)
        del server
        torch.cuda.empty_cache()
    want = runs["serve-rec-fp32"]
    for tag, limit, agree_min in (
            ("serve-rec-bf16", REC_BF16_DP, None),
            ("serve-rec-fused", REC_BF16_DP, None),
            ("serve-rec-int8", REC_INT8_DP, REC_INT8_AGREE)):
        agree, dp = score_agreement(runs[tag], want)
        metrics[tag].update(top1_agreement_vs_fp32=agree, max_dp_vs_fp32=dp)
        log(f"[{tag}] vs fp32: top-1 agreement {agree:.4f}, max |dp| "
            f"{dp:.4e} (tol {limit}"
            + (f", agreement >= {agree_min})" if agree_min else ")"))
        require(dp <= limit, f"{tag}: max |dp| vs fp32 {dp} > {limit}")
        if agree_min is not None:
            require(agree >= agree_min, f"{tag}: top-1 agreement {agree} < "
                    f"{agree_min}")
    top = want["action"].max(-1)
    log(f"[serve-rec] fp32 action top-1 probability: median "
        f"{np.median(top):.4f}, min {top.min():.4f}")
    return launches, metrics


def rec_runner(cfg, train_ds, val_ds, banked, **tkw):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    tcfg = C.TrainConfig(batch_size=REC_BATCH, epochs=1, seed=SEED, **tkw)
    runner = RecognitionRunner(cfg, tcfg, train_ds, val_ds, print_freq=1000,
                               use_device_bank=banked, device="cuda")
    runner.init_state()
    return runner


def phase_rec_grad_slice_fp32(train_ds):
    """17d (i): one fp32 train step of full-width ``epic_recognition``
    cut to 2 encoder layers (every dropout rate 0, mixup 0.2, drloc 0.3)
    on 2 windows, on the card and on the CPU with the same draws: losses
    and every parameter gradient (the middle third of ``in_proj_bias``,
    the k bias, whose gradient is 0 in exact arithmetic, excepted)."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.data.dataset import batch_iterator
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.train.recognition import make_train_step
    cfg = C.epic_recognition(compute_dtype="float32", num_layers=2,
                             enc_dropout=0.0, feat_dropout=0.0,
                             seq_dropout=0.0)
    tcfg = C.TrainConfig(mixup_alpha=0.2, lambda_drloc=0.3)
    cpu_model = TimRecognition(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    train_ds.sample_augmentations = False
    batch = next(batch_iterator(train_ds, 2, shuffle=False))
    train_ds.sample_augmentations = True
    ws = train_ds.windows
    nv, na = ws.max_visual_actions, ws.max_audio_actions
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = det_state(model, tcfg)
        grads = captured_grads(state)
        counters = zero_counts()
        metrics = make_train_step(model, cfg, tcfg, nv, na)(
            state, {k: torch.from_numpy(np.asarray(v)).to(dev)
                    for k, v in batch.items() if not k.startswith("_")
                    and not k.endswith("action_ids")})
        out[dev] = ({k: float(v) for k, v in metrics.items()}, grads,
                    read_counts(counters))
    (gm, gg, launches), (cm, cg, _) = out["cuda"], out["cpu"]
    require(attention_launches(launches) == 0,
            f"rec fp32 train step launched {launches}")
    rels = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30) for k in cm}
    worst_m = max(rels.values())
    log(f"[rec-grad-slice] metrics card vs CPU: "
        f"{json.dumps({k: [gm[k], cm[k]] for k in sorted(cm)})}; worst "
        f"relative {worst_m:.3e} (tol {REC_METRIC_RTOL})")
    require(sorted(gm) == sorted(cm) and worst_m <= REC_METRIC_RTOL,
            f"rec fp32 slice metrics: {worst_m} > {REC_METRIC_RTOL}")
    require(len(cg) == len(list(cpu_model.parameters())) == len(gg),
            "rec fp32 slice: gradients missing")
    worst, worst_name = 0.0, ""
    for name in cg:
        g, c = gg[name].cpu(), cg[name]
        if name.endswith("in_proj_bias"):
            third = len(c) // 3
            g = torch.cat([g[:third], g[2 * third:]])
            c = torch.cat([c[:third], c[2 * third:]])
        require(bool(torch.isfinite(g).all()), f"rec {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"rec fp32 gradient {name}: card vs "
                f"CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[rec-grad-slice] {len(cg)} parameter gradients within {worst:.3e} "
        f"of each tensor's largest value (worst {worst_name}; tol "
        f"{GRAD_SLICE_TOL})")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return {"grad_rel": worst, "metric_rel": worst_m}


def phase_rec_train(train_ds, val_ds):
    """17d (ii): ``RecognitionRunner.train_epoch`` on the banked path over
    7 batches of 64 windows, bf16, every dropout of the preset on, mixup
    0.2, drloc 0.3: 2 warm-up steps, then 5 timed steps with every count
    set to 0 just before them and read just after; then one step on the
    host path."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.data.dataset import batch_iterator
    runner = rec_runner(C.epic_recognition(), train_ds, val_ds, True,
                        mixup_alpha=0.2, lambda_drloc=0.3)
    require(runner._tables.num_windows // REC_BATCH
            == REC_WARMUP + REC_STEPS,
            f"rec split of {runner._tables.num_windows} windows")
    before = [p.detach().clone() for p in runner.model.parameters()]
    step = runner._bank_step
    metrics, marks = [], {}
    timed_step = EventTimed(step)

    def counted(state, batch):
        if len(metrics) == REC_WARMUP:
            marks["counters"] = zero_counts()
            timed_step.events.clear()
            marks["t0"] = time.perf_counter()
        out = timed_step(state, batch)
        metrics.append(out)
        return out

    torch.cuda.reset_peak_memory_stats()
    runner._bank_step = counted
    try:
        runner.train_epoch(0)
    finally:
        runner._bank_step = step
    launches = read_counts(marks["counters"])
    wall = time.perf_counter() - marks["t0"]
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in timed_step.events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, runner.model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    # one step on the host path: a numpy batch moved to the card
    host_batch = runner._to_device(next(batch_iterator(
        train_ds, REC_BATCH, shuffle=False)))
    host_timed = EventTimed(runner._train_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_metrics = host_timed(runner.state, host_batch)
    host_loss = float(host_metrics["loss"])
    host_wall = (time.perf_counter() - t0) * 1e3
    host_ms = host_timed.device_ms()
    log(f"[rec-train] {len(step_ms)} banked steps of batch {REC_BATCH} "
        f"(S = {runner.model.cfg.num_context + 3 * runner.nv + runner.na}): "
        f"device {ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}),"
        f" {REC_BATCH / (ms / 1e3):.2f} device windows/s; wall {wall:.3f} s,"
        f" {REC_STEPS * REC_BATCH / wall:.2f} wall windows/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; launches {launches}")
    log(f"[rec-train] host-path step: device {host_ms:.3f} ms, wall "
        f"{host_wall:.3f} ms, loss {host_loss:.5f}")
    require(len(step_ms) == REC_STEPS, f"rec-train: {len(step_ms)} steps")
    require(all(np.isfinite(losses + norms + [host_loss])),
            "rec-train: non-finite loss or gradient norm")
    require(moved == len(before), f"rec-train: {len(before) - moved} of "
            f"{len(before)} parameter tensors did not move")
    require(attention_launches(launches) == 0,
            f"rec-train: launches {launches}, expected no kernel 1, 2 or "
            f"other attention kernel in a train step")
    require_steady("rec-train", launches, REC_STEPS)
    return runner, launches, {
        "batch": REC_BATCH, "steps": REC_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_windows_per_s": REC_BATCH / (ms / 1e3),
        "wall_s": wall, "wall_windows_per_s": REC_STEPS * REC_BATCH / wall,
        "peak_bytes": peak, "losses": losses, "grad_norms": norms,
        "host_step_device_ms": host_ms, "host_step_wall_ms": host_wall}


def rec_validate(tag, runner):
    """``runner.validate()`` with every count set to 0 just before and
    read just after, its eval steps timed by CUDA events. Returns (stats,
    launches, metrics)."""
    step = runner._eval_step
    runner._eval_step = timed_eval = EventTimed(step)
    try:
        counters = zero_counts()
        t0 = time.perf_counter()
        stats = runner.validate()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        runner._eval_step = step
    n_batches = len(timed_eval.events)
    windows = runner.val_ds.windows
    n = len(windows.windows)
    device = timed_eval.device_ms()
    log(f"[{tag}] {n} windows in {n_batches} batches of {REC_BATCH}: device "
        f"{device:.3f} ms, {n / (device / 1e3):.2f} device windows/s; wall "
        f"{wall:.3f} s, {n / wall:.2f} wall windows/s; stats "
        f"{json.dumps(stats)}; launches {launches}")
    require(all(np.isfinite(v) for v in stats.values()),
            f"{tag}: non-finite statistics")
    require(launches["query_block_attention"]
            == runner.cfg.num_layers * n_batches
            and launches["fused_post_attention"] == 0,
            f"{tag}: launches {launches}, expected kernel 1 "
            f"{runner.cfg.num_layers} x {n_batches} batches, kernel 2 never")
    require_steady(tag, launches, n_batches)
    return stats, launches, {
        "windows": n, "batches": n_batches, "device_ms": device,
        "device_windows_per_s": n / (device / 1e3), "wall_s": wall,
        "wall_windows_per_s": n / wall}


def phase_rec_val(runner, val_ds):
    """17e: ``validate`` of the trained weights in bf16 on the banked path
    (twice: the vote sums bit-equal) and on the host path (every statistic
    within REC_VAL_RTOL); ``extract_predictions`` on both paths."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.evals.meters import WindowVoteAccumulator
    from tim_tpu_torch.runner.recognition import _head_spec
    banked, launches, m_banked = rec_validate("rec-val-banked", runner)
    host_runner = rec_runner(C.epic_recognition(), None, val_ds, False)
    host_runner.load_torch_checkpoint(runner.model.state_dict())
    host, _, m_host = rec_validate("rec-val-host", host_runner)
    require(sorted(banked) == sorted(host), "rec-val: statistic keys differ")
    rel = max(abs(banked[k] - host[k]) / max(abs(host[k]), 1e-30)
              for k in host)
    accs = []
    for _ in range(2):
        acc = WindowVoteAccumulator(val_ds.windows.num_actions,
                                    _head_spec(runner.cfg))
        runner._run_bank_accum(acc)
        accs.append(acc)
    same = all(np.array_equal(accs[0].sums[h], accs[1].sums[h])
               for h in accs[0].sums)
    log(f"[rec-val] banked vs host statistics within {rel:.3e} (tol "
        f"{REC_VAL_RTOL}); two banked vote sums bit-equal: {same}")
    require(rel <= REC_VAL_RTOL, f"rec-val: banked vs host {rel}")
    require(same, "rec-val: two banked validations differ")
    t0 = time.perf_counter()
    dump = runner.extract_predictions()
    dump_s = time.perf_counter() - t0
    dump_host = host_runner.extract_predictions()
    worst = max(float(np.abs(dump[k] - dump_host[k]).max())
                for k in ("verb", "noun", "action", "audio"))
    n_v = len(dump["v_narration_ids"])
    log(f"[rec-val] extract_predictions (banked) {dump_s:.3f} s: action "
        f"{dump['action'].shape}, audio {dump['audio'].shape}; banked vs "
        f"host scores within {worst:.3e}")
    require(dump["action"].shape[0] == n_v
            and dump_host["v_narration_ids"] == dump["v_narration_ids"]
            and np.allclose(dump["action"].sum(1), 1.0, atol=1e-6)
            and worst <= REC_VAL_RTOL,
            f"rec-val: extract_predictions differ ({worst})")
    del host_runner
    torch.cuda.empty_cache()
    return launches, {"banked": m_banked, "host": m_host, "paths_rel": rel,
                      "extract_s": dump_s, "extract_rel": worst}


def phase_rec_resume(runner, train_ds):
    """17d (iii): save the state after the timed steps, ``resume`` it into
    a fresh runner; one more banked step from both: bit-equal
    parameters."""
    import tempfile
    from tim_tpu_torch import config as C
    from tim_tpu_torch.train.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, runner.state, epoch=1)
        fresh = rec_runner(C.epic_recognition(), train_ds, None, True,
                           mixup_alpha=0.2, lambda_drloc=0.3)
        epoch = fresh.resume(tmp)
    require(epoch == 1 and fresh.state.step == runner.state.step,
            f"rec-resume: epoch {epoch}, step {fresh.state.step}")
    ids = torch.arange(REC_BATCH, device="cuda")
    for r in (runner, fresh):
        r._bank_step(r.state, r._tables.batch(ids))
    pairs = list(zip(runner.model.parameters(), fresh.model.parameters()))
    equal = sum(int(torch.equal(p, q)) for p, q in pairs)
    log(f"[rec-resume] one more step from the resumed and the uninterrupted "
        f"state: {equal} of {len(pairs)} parameter tensors bit-equal")
    require(equal == len(pairs), f"rec-resume: {len(pairs) - equal} tensors "
            f"differ")
    del fresh
    torch.cuda.empty_cache()
    return {"bit_equal": equal, "tensors": len(pairs)}


def phase_recognition(gen):
    """Phase 17; returns (kernel 1's recognition report, launches by
    path, (the train and validation splits, the trained state dict on the
    CPU))."""
    from tim_tpu_torch import config as C
    cfg = C.epic_recognition()
    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    train_ds, val_ds = rec_split(cfg, 4, rng), rec_split(cfg, 4, rng)
    # one query count a head for both splits (the banked eval step's
    # shapes are the train split's)
    for key in ("max_visual_actions", "max_audio_actions"):
        most = max(getattr(ds.windows, key) for ds in (train_ds, val_ds))
        for ds in (train_ds, val_ds):
            setattr(ds.windows, key, most)
    ws = val_ds.windows
    nq_val = 3 * ws.max_visual_actions + ws.max_audio_actions
    log(f"[rec] synthetic splits of {len(train_ds)} and {len(val_ds)} "
        f"windows ({ws.num_actions} actions, up to "
        f"{ws.max_visual_actions} visual and {ws.max_audio_actions} audio "
        f"queries a window) in {time.perf_counter() - t0:.2f} s")
    summary = {}
    sd, summary["slice"] = timed("rec-slice-fp32", phase_rec_slice_fp32, rng)
    report = timed("rec-kernels", phase_rec_kernels, gen, nq_val)
    serve_launches, summary["serve"] = timed("rec-serve", phase_rec_serve,
                                             sd, rng)
    del sd
    summary["grad_slice"] = timed("rec-grad-slice",
                                  phase_rec_grad_slice_fp32, train_ds)
    runner, train_launches, summary["train"] = timed(
        "rec-train", phase_rec_train, train_ds, val_ds)
    val_launches, summary["val"] = timed("rec-val", phase_rec_val, runner,
                                         val_ds)
    summary["resume"] = timed("rec-resume", phase_rec_resume, runner,
                              train_ds)
    log(f"[rec] summary {json.dumps(summary)}")
    trained = {k: v.detach().cpu() for k, v in
               runner.model.state_dict().items()}
    del runner
    torch.cuda.empty_cache()
    return report, {"serve-rec-bf16": serve_launches["serve-rec-bf16"],
                    "serve-rec-int8": serve_launches["serve-rec-int8"],
                    "serve-rec-fused": serve_launches["serve-rec-fused"],
                    "rec-train": train_launches,
                    "rec-val": val_launches}, (train_ds, val_ds, trained)


# Phase 18: the detection mAP chain on phase 16's runner and validation
# split.
MAP_TOPK = 8
MAP_CANDIDATES = 20000     # the score threshold: what about this many clear
MAP_SCORE_TOL = 1e-3       # fp32 dumps, card vs CPU
MAP_AVG_TOL = 1e-6         # avg mAP of the card's and the CPU's fp32 dumps
MAP_FP32_WINDOWS = 4
MAP_PSEUDO_GT = 100


def det_gt(ds):
    """Evaluator GT columns of a detection split: its windows' visual
    actions, each once."""
    from tim_tpu_torch.evals.format_predictions import gt_to_columns
    rows = {}
    for w in ds.windows.windows:
        for (s, e), lab in zip(w.v_queries, w.v_labels):
            rows[(w.video_id, float(s), float(e), int(lab[2]))] = None
    vids, starts, stops, labels = zip(*rows)
    return gt_to_columns(np.asarray(vids, object), np.asarray(starts),
                         np.asarray(stops), np.asarray(labels))


def det_subset(ds, n):
    """The first ``n`` windows of ``ds`` as a split of their own."""
    sub = copy.copy(ds)
    sub.windows = dataclasses.replace(ds.windows,
                                      windows=ds.windows.windows[:n])
    return sub


def threshold_for(values, n):
    """The score that ``n`` of ``values`` clear."""
    flat = np.sort(np.asarray(values).ravel())
    return float(flat[max(len(flat) - n, 0)])


def phase_det_map(runner, val_ds):
    """Phase 18: on phase 16's trained runner (its regression heads' two
    sigmoids biased apart, so that proposals are intervals):
    ``extract_dense_predictions`` top-8 on the banked path (kernel 1 six
    times a batch) and the host path (the same rows), the top-8 columns
    against a dense dump, ``evaluate_detections`` of the banked dump
    against the split's GT; an fp32 card vs CPU dump of 4 windows and the
    mAP of each against GT made of the CPU dump's 100 best detections,
    shifted; GT fed back as the predictions gives avg mAP 1.0."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.evals.format_predictions import (
        evaluate_detections, gt_to_columns, nms_per_video,
        threshold_predictions)
    from tim_tpu_torch.runner.detection import DetectionRunner
    with torch.no_grad():
        for mlp in (runner.model.reg_head.fc_visual_action,
                    runner.model.reg_head.fc_audio_action):
            mlp[4].bias.copy_(torch.tensor([-1.0, 1.0]))
    sd = runner.model.state_dict()
    gt = det_gt(val_ds)
    n_win = len(val_ds)
    n_batches = -(-n_win // DET_BATCH)
    counters = zero_counts()
    t0 = time.perf_counter()
    dump = runner.extract_dense_predictions(top_k=MAP_TOPK)
    dump_s = time.perf_counter() - t0
    launches = read_counts(counters)
    require(launches["query_block_attention"] == 6 * n_batches
            and launches["fused_post_attention"] == 0,
            f"det-map: launches {launches}, expected kernel 1 6 x "
            f"{n_batches} batches")
    require_steady("det-map", launches, n_batches)
    rows = n_win * runner.num_queries
    require(len(dump["video_ids"]) == rows
            and dump["action_topk_values"].shape == (rows, MAP_TOPK),
            f"det-map: dump of {len(dump['video_ids'])} rows")
    thr = threshold_for(dump["action_topk_values"], MAP_CANDIDATES)
    t0 = time.perf_counter()
    m_ap, avg, sub = evaluate_detections(
        dump["video_ids"], dump["v_proposals"],
        (dump["action_topk_values"], dump["action_topk_classes"]), gt,
        score_threshold=thr, topk_num_classes=runner.cfg.visual_classes[-1])
    eval_s = time.perf_counter() - t0
    n_det = sum(len(v) for v in sub["results"].values())
    log(f"[det-map] banked top-{MAP_TOPK} dump of {n_win} windows ({rows} "
        f"rows) {dump_s:.3f} s; evaluate_detections (threshold {thr:.5f}, "
        f"{n_det} detections after Soft-NMS, {len(gt['label'])} GT) "
        f"{eval_s:.3f} s: mAP {np.round(m_ap, 6).tolist()}, avg {avg:.6f}; "
        f"launches {launches}")
    require(n_det > 0 and np.isfinite(avg), "det-map: no detections")

    host = det_runner(C.epic_detection(), None, val_ds, False)
    host.load_torch_checkpoint(sd)
    t0 = time.perf_counter()
    hdump = host.extract_dense_predictions(top_k=MAP_TOPK)
    host_s = time.perf_counter() - t0
    same_rows = (np.array_equal(hdump["video_ids"], dump["video_ids"])
                 and np.array_equal(hdump["queries"], dump["queries"]))
    h_err = max(float(np.abs(hdump[k] - dump[k]).max())
                for k in ("action_topk_values", "v_proposals"))
    log(f"[det-map] host-path dump {host_s:.3f} s: the same rows {same_rows}"
        f", top-{MAP_TOPK} scores and proposals within {h_err:.3e} of the "
        f"banked dump")
    require(same_rows and h_err <= MAP_SCORE_TOL,
            f"det-map: host vs banked dumps ({same_rows}, {h_err})")
    # the top-k columns against the dense scores of the same windows
    sub64 = det_subset(val_ds, DET_BATCH)
    dense = host.extract_dense_predictions(dataset=sub64)["action"]
    topk = host.extract_dense_predictions(dataset=sub64, top_k=MAP_TOPK)
    vals, cls = topk["action_topk_values"], topk["action_topk_classes"]
    picked = np.take_along_axis(dense, cls.astype(np.int64), -1)
    rest = dense.copy()
    np.put_along_axis(rest, cls.astype(np.int64), -np.inf, -1)
    k_err = float(np.abs(picked - vals).max())
    order_ok = bool((rest.max(-1) <= vals.min(-1) + 1e-6).all())
    log(f"[det-map] top-{MAP_TOPK} columns vs the dense dump of "
        f"{DET_BATCH} windows: values within {k_err:.3e}, no class left out "
        f"scores above the k-th: {order_ok}")
    require(k_err <= 1e-6 and order_ok, "det-map: top-k columns disagree "
            "with the dense scores")
    del host, dense, rest, picked
    torch.cuda.empty_cache()

    # fp32, card vs CPU, on 4 windows in one batch of 4
    sub4 = det_subset(val_ds, MAP_FP32_WINDOWS)
    cfg32 = C.epic_detection(compute_dtype="float32")
    tcfg4 = C.TrainConfig(batch_size=MAP_FP32_WINDOWS, epochs=1, seed=SEED)
    dumps, secs = {}, {}
    for dev in ("cuda", "cpu"):
        r = DetectionRunner(cfg32, tcfg4, None, sub4, print_freq=1000,
                            device=dev)
        r.load_torch_checkpoint(sd)
        t0 = time.perf_counter()
        dumps[dev] = r.extract_dense_predictions()
        secs[dev] = time.perf_counter() - t0
        del r
    g, c = dumps["cuda"], dumps["cpu"]
    f_err = max(float(np.abs(g[k] - c[k]).max())
                for k in ("action", "audio", "v_proposals", "a_proposals"))
    # GT that random weights can hit: the CPU dump's MAP_PSEUDO_GT best
    # detections after Soft-NMS, each shifted by up to 60% of its length
    # (tIoU 0.25-1 with the detection), so that the mAP compared lies
    # between 0 and 1 and moves with the scores' order and the proposals
    thr4 = threshold_for(c["action"], 2000)
    dets = nms_per_video(threshold_predictions(
        c["video_ids"], c["v_proposals"], c["action"], thr4))
    flat = [(s, v, seg, lab) for v, d in dets.items()
            for s, seg, lab in zip(d["scores"], d["segments"], d["labels"])]
    flat.sort(key=lambda r: -r[0])
    _, g_vid, g_seg, g_lab = zip(*flat[:MAP_PSEUDO_GT])
    g_seg = np.asarray(g_seg, np.float64)
    shift = (np.random.default_rng(SEED).uniform(-0.6, 0.6, len(g_seg))
             * (g_seg[:, 1] - g_seg[:, 0]))
    gt4 = gt_to_columns(np.asarray(g_vid, object), g_seg[:, 0] + shift,
                        g_seg[:, 1] + shift, np.asarray(g_lab))
    maps = {}
    for dev, d in dumps.items():
        maps[dev] = evaluate_detections(d["video_ids"], d["v_proposals"],
                                        d["action"], gt4,
                                        score_threshold=thr4)[:2]
    d_avg = abs(maps["cuda"][1] - maps["cpu"][1])
    log(f"[det-map] fp32 dump of {MAP_FP32_WINDOWS} windows: card "
        f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s, scores and "
        f"proposals within {f_err:.3e} (tol {MAP_SCORE_TOL}); avg mAP card "
        f"{maps['cuda'][1]:.8f}, CPU {maps['cpu'][1]:.8f} (|diff| "
        f"{d_avg:.2e}, tol {MAP_AVG_TOL})")
    require(np.array_equal(g["video_ids"], c["video_ids"])
            and f_err <= MAP_SCORE_TOL, f"det-map fp32: {f_err}")
    require(d_avg <= MAP_AVG_TOL and 0.05 < maps["cpu"][1] < 0.95,
            f"det-map fp32 avg mAP differ by {d_avg} (CPU "
            f"{maps['cpu'][1]})")

    # control: the GT fed back as proposals scores avg mAP 1.0
    labels = np.asarray(gt["label"], np.int64)
    onehot = np.full((len(labels), runner.cfg.visual_classes[-1]), 1e-4,
                     np.float32)
    onehot[np.arange(len(labels)), labels] = 0.9
    _, perfect, _ = evaluate_detections(
        gt["video-id"], np.stack([gt["t-start"], gt["t-end"]], -1), onehot,
        gt)
    log(f"[det-map] control: GT fed back as the predictions, avg mAP "
        f"{perfect:.6f}")
    require(abs(perfect - 1.0) <= 1e-9, f"det-map control: {perfect}")
    return launches, {
        "windows": n_win, "dump_s": dump_s, "host_dump_s": host_s,
        "eval_s": eval_s, "avg_mAP": avg, "detections": n_det,
        "fp32_dump_card_s": secs["cuda"], "fp32_dump_cpu_s": secs["cpu"],
        "fp32_rel": f_err, "fp32_avg_diff": d_avg, "control_avg": perfect}


# Phase 19: the command lines and the checkpoint gate, on phase 16's and
# 17's full-width splits: the TIM CLI (``cli.run``, banked, bf16, batch 64)
# builds the EPIC models of its defaults (detection: the 97-verb head and
# 44 audio classes; recognition: 97/300/3806/44).
CLI_TOL = 1e-3             # CLI runs vs the runner's own, same weights
CLI_TOPK = 8
GATE_NUM_FEATS = "50"      # the CLI's models take 50 features a window


def cli_args(variant, out, *extra):
    """Parsed TIM CLI flags at the parser's defaults, banked, output to
    ``out``."""
    from tim_tpu_torch import cli
    return cli.build_parser().parse_args(
        ["--variant", variant, "--output_dir", str(out), "--device_bank",
         "true", "--print-freq", "1000", *extra])


def epic_detection_split(ds, train):
    """``ds``'s windows and banks as ``cli.load_datasets`` builds an EPIC
    detection split: verb labels (``--verb_only``, the CLI's 97-class
    head), augmentation sets sampled on the train split only."""
    from tim_tpu_torch.data.dataset import DetectionDataset
    return DetectionDataset(ds.windows, ds.visual, ds.audio,
                            sample_augmentations=train, verb_only=True,
                            include_verb_noun=False, dataset_name="epic")


def cli_run(tag, args, train_ds, val_ds):
    """``cli.run`` on the card with every count set to 0 just before and
    read just after. Returns (result, launches, seconds)."""
    from tim_tpu_torch import cli
    counters = zero_counts()
    t0 = time.perf_counter()
    out = cli.run(args, train_ds, val_ds, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    log(f"[{tag}] cli.run {secs:.3f} s; launches {launches}")
    return out, launches, secs


def stats_diff(tag, got, want):
    """The largest |got - want| of two statistics dicts, relative to
    max(1, |want|); fails unless every value is finite and within
    CLI_TOL."""
    require(sorted(got) == sorted(want), f"{tag}: statistics keys differ")
    diff = max(abs(float(got[k]) - float(want[k]))
               / max(1.0, abs(float(want[k]))) for k in want)
    require(all(np.isfinite(float(v)) for v in got.values()),
            f"{tag}: non-finite statistics {got}")
    require(diff <= CLI_TOL, f"{tag}: {diff} > {CLI_TOL}")
    return diff


def dump_diff(tag, got, want, keys):
    """The largest difference of two dumps' numeric columns, each relative
    to max(1, its largest |want|)."""
    require(all(k in got for k in keys), f"{tag}: dump keys {sorted(got)}")
    diff = max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               / max(1.0, float(np.abs(want[k]).max())) for k in keys)
    require(diff <= CLI_TOL, f"{tag}: dumps differ by {diff}")
    return diff


def require_kernel1(tag, launches, per_batch, batches):
    require(launches["query_block_attention"] == per_batch * batches
            and launches["fused_post_attention"] == 0,
            f"{tag}: launches {launches}, expected kernel 1 {per_batch} x "
            f"{batches} batches, kernel 2 never")


def phase_cli_detection(train_ds, val_ds, out):
    """19a: ``--train`` for one epoch, then ``--validate`` and
    ``--extract_feats --extract_top_k 8`` resumed from its checkpoint,
    each against a ``DetectionRunner`` resumed from the same checkpoint.
    Returns (launches by path, metrics, the reference-format checkpoint)."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.runner.detection import DetectionRunner
    train_ds = epic_detection_split(train_ds, True)
    val_ds = epic_detection_split(val_ds, False)
    n_val = len(val_ds)
    val_batches, dump_batches = n_val // DET_BATCH, -(-n_val // DET_BATCH)
    args = cli_args("detection", out, "--train", "--finetune_epochs", "1")
    mcfg, tcfg = cli.configs_from_args(args)
    layers = mcfg.num_layers
    fit_stats, l_train, s_train = cli_run("cli-det-train", args, train_ds,
                                          val_ds)
    require_kernel1("cli-det-train", l_train, layers, val_batches)
    payload = torch.load(out / "checkpoint.pt", map_location="cpu",
                         weights_only=True)
    require(payload["epoch"] == 1 and payload["step"] == len(train_ds)
            // DET_BATCH, f"cli-det-train: checkpoint epoch "
            f"{payload['epoch']}, step {payload['step']}")

    args = cli_args("detection", out, "--validate", "--resume", str(out))
    val_stats, l_val, s_val = cli_run("cli-det-val", args, None, val_ds)
    require_kernel1("cli-det-val", l_val, layers, val_batches)
    runner = DetectionRunner(mcfg, tcfg, None, val_ds, print_freq=1000,
                             use_device_bank=True, device="cuda")
    runner.resume(str(out))
    own = runner.validate()
    d_val = stats_diff("cli-det-val", val_stats, own)
    d_fit = stats_diff("cli-det-train", fit_stats, own)

    args = cli_args("detection", out, "--extract_feats", "--extract_top_k",
                    str(CLI_TOPK), "--resume", str(out))
    dump, l_dump, s_dump = cli_run("cli-det-dump", args, None, val_ds)
    require_kernel1("cli-det-dump", l_dump, layers, dump_batches)
    with np.load(out / "dense_predictions.npz", allow_pickle=True) as f:
        saved = {k: f[k] for k in f.files}
    require(sorted(saved) == sorted(dump)
            and list(saved["video_ids"]) == list(dump["video_ids"]),
            "cli-det-dump: the file differs from the returned dump")
    own_dump = runner.extract_dense_predictions(top_k=CLI_TOPK)
    cols = ("queries", "v_proposals", "a_proposals", "action_topk_values",
            "audio_topk_values")
    d_dump = dump_diff("cli-det-dump", saved, own_dump, cols)
    rows = len(dump["video_ids"])
    require(rows == n_val * runner.num_queries
            and dump["action_topk_values"].shape == (rows, CLI_TOPK),
            f"cli-det-dump: {rows} rows")
    sizes = {f.name: f.stat().st_size for f in sorted(out.glob("*.pt"))}
    log(f"[cli-det] train 1 epoch ({len(train_ds)} windows) {s_train:.3f} "
        f"s (checkpoint files {json.dumps(sizes)} bytes), stats "
        f"{json.dumps(fit_stats)}; validate {s_val:.3f} s; dump "
        f"{s_dump:.3f} s ({rows} rows, top-{CLI_TOPK}); against the "
        f"runner's own: validate {d_val:.3e}, train's last validation "
        f"{d_fit:.3e}, dump {d_dump:.3e} (tol {CLI_TOL})")
    path = out / "tim_detection.pyth"
    torch.save({"state_dict": payload["params"], "epoch": payload["epoch"]},
               path)
    del runner
    torch.cuda.empty_cache()
    return ({"cli-det-train": l_train, "cli-det-val": l_val,
             "cli-det-dump": l_dump},
            {"train_s": s_train, "val_s": s_val, "dump_s": s_dump,
             "val_diff": d_val, "fit_diff": d_fit, "dump_diff": d_dump},
            path)


def phase_cli_recognition(val_ds, state_dict, out):
    """19b: phase 17's trained weights saved in the reference's format,
    ``--validate`` and ``--extract_feats`` with ``--torch_checkpoint`` on
    them, each against a ``RecognitionRunner`` with the same weights.
    Returns (launches by path, metrics, the checkpoint)."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    path = out / "tim_recognition.pyth"
    torch.save({"state_dict": state_dict, "epoch": 1}, path)
    args = cli_args("recognition", out, "--validate", "--torch_checkpoint",
                    str(path))
    mcfg, tcfg = cli.configs_from_args(args)
    runner = RecognitionRunner(mcfg, tcfg, None, val_ds, print_freq=1000,
                               use_device_bank=True, device="cuda")
    runner.load_torch_checkpoint(state_dict)
    counters = zero_counts()
    own = runner.validate()
    l_own = read_counts(counters)
    stats, l_val, s_val = cli_run("cli-rec-val", args, None, val_ds)
    batches = -(-len(val_ds) // REC_BATCH)
    require_kernel1("cli-rec-val", l_val, mcfg.num_layers, batches)
    require(l_val == l_own, f"cli-rec-val: launches {l_val}, the runner's "
            f"own {l_own}")
    d_val = stats_diff("cli-rec-val", stats, own)

    args = cli_args("recognition", out, "--extract_feats",
                    "--torch_checkpoint", str(path))
    preds, l_dump, s_dump = cli_run("cli-rec-dump", args, None, val_ds)
    require_kernel1("cli-rec-dump", l_dump, mcfg.num_layers, batches)
    require((out / "val_features.pkl").exists(),
            "cli-rec-dump: no val_features.pkl")
    own_preds = runner.extract_predictions()
    require(preds["v_narration_ids"] == own_preds["v_narration_ids"]
            and preds["a_narration_ids"] == own_preds["a_narration_ids"],
            "cli-rec-dump: narration ids differ")
    d_dump = dump_diff("cli-rec-dump", preds, own_preds,
                       ("verb", "noun", "action", "audio"))
    log(f"[cli-rec] validate {s_val:.3f} s, stats {json.dumps(stats)}; "
        f"extract {s_dump:.3f} s (action {preds['action'].shape}); against "
        f"the runner's own: validate {d_val:.3e}, predictions {d_dump:.3e} "
        f"(tol {CLI_TOL})")
    del runner
    torch.cuda.empty_cache()
    return ({"cli-rec-val": l_val, "cli-rec-dump": l_dump},
            {"val_s": s_val, "dump_s": s_dump, "val_diff": d_val,
             "dump_diff": d_dump}, path)


def phase_gate(task, path):
    """19c: ``validate_checkpoint`` on a full-width checkpoint on the card:
    load, infer, convert and contract PASS, parity SKIPs (no reference
    tree); the contract's fp32 model launches kernel 1 once a layer, the
    detection contract's fused int8 class heads kernel 3 twice."""
    from tim_tpu_torch import validate_checkpoint as VC
    counters = zero_counts()
    t0 = time.perf_counter()
    gate = VC.validate([str(path), "--task", task, "--num_feats",
                        GATE_NUM_FEATS], device="cuda")
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    tag = f"gate-{task}"
    contract = gate.numbers.get("contract", {})
    log(f"[{tag}] stages {json.dumps(gate.tags)}; seconds "
        f"{json.dumps({k: round(v, 3) for k, v in gate.seconds.items()})}, "
        f"{secs:.3f} s in all; contract {json.dumps(contract)}; launches "
        f"{launches}")
    want = {"load": "PASS", "infer": "PASS", "convert": "PASS",
            "parity": "SKIP", "contract": "PASS"}
    require(gate.tags == want, f"{tag}: stages {gate.tags}")
    layers = gate.numbers["infer"]["num_layers"]
    heads = 2 if task == "detection" else 0
    require(launches["query_block_attention"] == layers
            and launches["int8_matmul_fused"] == heads,
            f"{tag}: launches {launches}, expected kernel 1 {layers} "
            f"times, kernel 3 {heads}")
    return launches, {"contract": contract, "seconds": gate.seconds,
                      "total_s": secs}


def phase_cli_and_gate(det_splits, rec_val_ds, rec_state_dict):
    """Phase 19; returns the launches by path."""
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        det_out = pathlib.Path(tmp) / "detection"
        rec_out = pathlib.Path(tmp) / "recognition"
        det_out.mkdir()
        rec_out.mkdir()
        det_l, det_m, det_path = timed("cli-detection", phase_cli_detection,
                                       *det_splits, det_out)
        rec_l, rec_m, rec_path = timed("cli-recognition",
                                       phase_cli_recognition, rec_val_ds,
                                       rec_state_dict, rec_out)
        paths, gates = {**det_l, **rec_l}, {}
        for task, path in (("detection", det_path),
                           ("recognition", rec_path)):
            paths[f"gate-{task}"], gates[task] = timed(
                f"gate-{task}", phase_gate, task, path)
    log(f"[cli] summary {json.dumps({'detection': det_m, 'recognition': rec_m, 'gate': gates})}")
    return paths


# Phase 20: Auditory SlowFast at the EPIC-Sounds defaults (R50, width 64,
# alpha 4, beta_inv 8, 2304-d feature) in fp32, random weights from the
# seed; audio extraction over a synthetic 60 s waveform.
AUDIO_SR = 24000
AUDIO_SECONDS, AUDIO_HOP, AUDIO_RECORD = 60.0, 0.2, 1.1
AUDIO_NUM_AUG, AUDIO_BATCH = 2, 8
AUDIO_TOL = 1e-3           # fp32 card vs CPU, of the largest feature / logit
AUDIO_CLIP_TOL = 1e-4      # bank rows vs per-clip forwards on the card
AUDIO_CHECK_CLIPS = 12


def phase_audio_slice_fp32(wave):
    """20a: full-size ``AuditorySlowFast()`` on one clip (a 0.999 s crop's
    spectrogram, [1, 1, 200, 128]), card against CPU."""
    from tim_tpu_torch.extract.audio import (
        extract_clip_spectrogram, record_clip_bounds)
    from tim_tpu_torch.models.backbones.slowfast import (
        AuditorySlowFast, pack_pathways)
    lo, hi = record_clip_bounds(0, int(round(AUDIO_RECORD * AUDIO_SR)),
                                int(round(0.999 * AUDIO_SR)), 0, 1)
    spec = extract_clip_spectrogram(wave, lo, hi, sampling_rate=AUDIO_SR)
    x = torch.from_numpy(spec)[None, None]
    models = {d: AuditorySlowFast(device=d, generator=torch.Generator()
                                  .manual_seed(SEED))
              for d in ("cpu", "cuda")}
    out, secs = {}, {}
    for dev, model in models.items():
        t0 = time.perf_counter()
        out[dev] = [t.float().cpu() for t in
                    model(*pack_pathways(x.to(dev), model.alpha))]
        secs[dev] = time.perf_counter() - t0
    (g_logits, g_feat), (c_logits, c_feat) = out["cuda"], out["cpu"]
    err_f = ((g_feat - c_feat).abs().max() / c_feat.abs().max()).item()
    err_l = ((g_logits - c_logits).abs().max() / c_logits.abs().max()).item()
    n_params = sum(p.numel() for p in models["cpu"].parameters())
    log(f"[audio-slice-fp32] AuditorySlowFast ({n_params} parameters) on "
        f"[1, 1, {spec.shape[0]}, {spec.shape[1]}]: feature "
        f"{tuple(c_feat.shape)}, card vs CPU feature {err_f:.3e}, "
        f"probabilities {err_l:.3e} of the largest (tol {AUDIO_TOL}); "
        f"card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; cuDNN TF32 "
        f"flag {torch.backends.cudnn.allow_tf32} (restored)")
    require(tuple(c_feat.shape) == (1, 2304) and spec.shape == (200, 128),
            f"audio-slice: feature {tuple(c_feat.shape)}, spectrogram "
            f"{spec.shape}")
    require(err_f <= AUDIO_TOL and err_l <= AUDIO_TOL,
            f"audio-slice: card vs CPU {err_f}, {err_l}")
    return {"feature_rel": err_f, "prob_rel": err_l, "card_s": secs["cuda"],
            "cpu_s": secs["cpu"]}


def phase_audio_extract(wave):
    """20b: ``make_audio_apply`` and ``extract_features_for_video`` over
    the waveform with the CLI's clip function (records of 1.1 s every
    0.2 s, two augmentation sets: the clean crop and a SpecAugment one,
    batch 8); counts set to 0 just before and read just after; device
    (CUDA events) and wall clips/s, peak memory; the clean set against
    per-clip forwards."""
    import random
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import extract_features_for_video
    args = ecli.build_parser().parse_args(
        ["--backbone", "slowfast", "--feature_times", "-", "--out_dir", "-",
         "--num_aug", str(AUDIO_NUM_AUG), "--batch_size", str(AUDIO_BATCH)])
    apply_fn = ecli.make_audio_apply(args, device="cuda")
    starts = np.arange(0.0, AUDIO_SECONDS - AUDIO_RECORD + 1e-6, AUDIO_HOP)
    n = len(starts)
    clip_fn = ecli.audio_clip_fn(wave, starts, starts + AUDIO_RECORD,
                                 AUDIO_SR, AUDIO_NUM_AUG)
    timed_apply = EventTimed(apply_fn)
    timed_apply.device = apply_fn.device
    random.seed(SEED)                        # SpecAugment's draws
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    t0 = time.perf_counter()
    bank = extract_features_for_video(clip_fn, n, AUDIO_NUM_AUG, timed_apply,
                                      batch_size=AUDIO_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    clips = n * AUDIO_NUM_AUG
    device = timed_apply.device_ms()
    t0 = time.perf_counter()
    for t in range(min(n, 16)):
        clip_fn(t, 1)
    aug_ms = (time.perf_counter() - t0) * 1e3 / min(n, 16)
    worst = 0.0
    for t in np.linspace(0, n - 1, AUDIO_CHECK_CLIPS).astype(int):
        one = apply_fn(torch.from_numpy(clip_fn(int(t), 0))[None].cuda())
        want = one[0].cpu().numpy()
        worst = max(worst, float(np.abs(bank[t, 0] - want).max()
                                 / np.abs(want).max()))
    log(f"[audio-extract] {n} records x {AUDIO_NUM_AUG} sets = {clips} clips "
        f"of a {AUDIO_SECONDS:.0f} s waveform, batch {AUDIO_BATCH}: device "
        f"{device:.3f} ms ({len(timed_apply.events)} batches), "
        f"{clips / (device / 1e3):.2f} device clips/s; wall {wall:.3f} s, "
        f"{clips / wall:.2f} wall clips/s (a SpecAugment clip's host "
        f"spectrogram {aug_ms:.2f} ms); peak max_memory_allocated "
        f"{peak / 2 ** 30:.3f} GiB; bank {bank.shape}; clean set vs "
        f"{AUDIO_CHECK_CLIPS} per-clip forwards {worst:.3e} (tol "
        f"{AUDIO_CLIP_TOL}); launches {launches}")
    require(bank.shape == (n, AUDIO_NUM_AUG, 2304)
            and np.isfinite(bank).all(), f"audio-extract: bank {bank.shape}")
    require(not np.allclose(bank[:, 0], bank[:, 1]),
            "audio-extract: the SpecAugment set equals the clean set")
    require(worst <= AUDIO_CLIP_TOL, f"audio-extract: clean set vs per-clip "
            f"forwards {worst}")
    return launches, {
        "records": n, "clips": clips, "device_ms": device,
        "device_clips_per_s": clips / (device / 1e3), "wall_s": wall,
        "wall_clips_per_s": clips / wall, "spec_augment_clip_ms": aug_ms,
        "peak_bytes": peak, "clean_vs_per_clip": worst}


def phase_audio():
    """Phase 20; returns the extraction's launches by path."""
    wave = np.random.default_rng(SEED).normal(
        scale=0.1, size=int(AUDIO_SECONDS * AUDIO_SR)).astype(np.float32)
    summary = {"slice": timed("audio-slice-fp32", phase_audio_slice_fp32,
                              wave)}
    launches, summary["extract"] = timed("audio-extract",
                                         phase_audio_extract, wave)
    log(f"[audio] summary {json.dumps(summary)}")
    torch.cuda.empty_cache()
    return {"audio-extract": launches}


# ---------------------------------------------------------------------------
# Phase 27: the command lines on the reference's files. The port needs
# neither pandas nor pyarrow: it reads the DataFrame pickles and the CSV
# of tests/data/torch_tables (EPIC-KITCHENS-100 and EPIC-Sounds annotations,
# feature-time and video-info tables, written by its make_fixture.py) with
# utils.pdpickle and data.table; each file's .npz twin (numpy alone) says
# what the file holds.
# ---------------------------------------------------------------------------
TABLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "data", "torch_tables")
FILES_SPLITS = {  # the CLI's split name: (EPIC-100, EPIC-Sounds, times)
    "train": ("EPIC_100_train.pkl", "EPIC_Sounds_train.pkl",
              "feature_times_train.pkl"),
    "val": ("EPIC_100_validation.pkl", "EPIC_Sounds_validation.pkl",
            "feature_times_validation.pkl.gz")}
# extract.cli's --num_shards / --shard_id over the train feature times: the
# fourth of its four videos (sorted), the 60 s one without annotations
FILES_AUDIO_SHARD = (4, 3)
FILES_AUDIO_NUM_AUG = 2
FILES_TOPK = 8


def tables_fixture():
    """``tests/data/torch_tables/make_fixture.py`` as a module (numpy
    alone at import: ``read_twin`` and the file names)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_tables_fixture", os.path.join(TABLES_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def files_read(fixture):
    """27a: every fixture file read by ``read_pickle`` / ``read_csv``
    against its twin: columns, dtypes and index equal, numbers bit for
    bit, NaN in the same places."""
    from tim_tpu_torch.data.table import read_csv
    from tim_tpu_torch.utils.pdpickle import read_pickle
    out = {}
    for name in fixture.PICKLES + fixture.CSVS:
        path = os.path.join(TABLES_DIR, name)
        t0 = time.perf_counter()
        table = read_csv(path) if name.endswith(".csv") else \
            read_pickle(path)
        secs = time.perf_counter() - t0
        require(table.equals(fixture.read_twin(fixture.twin_path(path))),
                f"files-read: {name} differs from its twin")
        out[name] = {"bytes": os.path.getsize(path), "rows": len(table),
                     "read_s": secs}
        log(f"[files-read] {name}: {out[name]['bytes']} bytes, {len(table)} "
            f"rows x {len(table.columns)} columns, read in {secs:.6f} s, "
            f"equal to its twin")
    return out


def files_argv(banks, out, variant, *extra):
    """The TIM CLI's flags over the fixture's files and the variant's npy
    banks under ``banks``, at the parser's defaults (EPIC, bf16, batch
    64), banked."""
    argv = ["--variant", variant, "--output_dir", str(out),
            "--device_bank", "true", "--print-freq", "1000",
            "--video_data_path", str(banks / variant / "visual"),
            "--audio_data_path", str(banks / variant / "audio"),
            "--video_info_pickle", os.path.join(TABLES_DIR, "video_info.pkl")]
    for split, (actions, sounds, times) in FILES_SPLITS.items():
        for flag, name in (("video_{}_action_pickle", actions),
                           ("audio_{}_action_pickle", sounds),
                           ("video_{}_context_pickle", times),
                           ("audio_{}_context_pickle", times)):
            argv += ["--" + flag.format(split),
                     os.path.join(TABLES_DIR, name)]
    return argv + list(extra)


def files_banks(fixture, banks):
    """Seeded [T, 2, dim] float32 banks at the CLI's EPIC widths of each
    variant (detection's visual 2048, recognition's 1024, audio 2304) for
    every video of the feature-time tables (T its rows there; recognition
    only validates: its val split alone). Returns the bytes written."""
    from tim_tpu_torch import cli
    rng = np.random.default_rng(SEED + 27)
    n = 0
    for variant, splits in (("detection", ("train", "val")),
                            ("recognition", ("val",))):
        mcfg, _ = cli.configs_from_args(cli.build_parser().parse_args(
            ["--variant", variant]))
        for split in splits:
            table = fixture.read_twin(fixture.twin_path(
                os.path.join(TABLES_DIR, FILES_SPLITS[split][2])))
            for modality, dim in (("visual", mcfg.visual_input_dim),
                                  ("audio", mcfg.audio_input_dim)):
                folder = banks / variant / modality / split
                folder.mkdir(parents=True)
                for vid in table.unique("video_id"):
                    rows = int((table["video_id"] == vid).sum())
                    np.save(folder / f"{vid}.npy", rng.standard_normal(
                        (rows, 2, dim), np.float32))
                    n += rows * 2 * dim * 4
    return n


def files_cli(tag, run):
    """``run()`` (a command line's entry) with every count set to 0 just
    before and read just after, and each ``DetectionRunner.train_epoch``'s
    statistics kept. Returns (result, launches, epochs, seconds)."""
    from tim_tpu_torch.runner.detection import DetectionRunner
    epochs, orig = [], DetectionRunner.train_epoch

    def train_epoch(self, epoch):
        epochs.append(orig(self, epoch))
        return epochs[-1]

    DetectionRunner.train_epoch = train_epoch
    try:
        counters = zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        DetectionRunner.train_epoch = orig
    log(f"[{tag}] {secs:.3f} s; launches {launches}")
    return out, launches, epochs, secs


def twin_read_pickle(fixture):
    """``utils.pdpickle.read_pickle`` replaced by the twin of each file."""
    from tim_tpu_torch.data.table import Table

    def read(path) -> Table:
        return fixture.read_twin(fixture.twin_path(os.fspath(path)))

    return read


def files_det(fixture, banks, tmp):
    """27b-d: ``cli.main --train --validate`` on the files, the same flags
    through ``cli.run`` on splits the port built from the twins (bit-equal
    losses, validation statistics and weights), the top-8 dump and the
    ``evals`` main on it against the EPIC-100 validation pickle."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.evals.__main__ import main as evals_main
    from tim_tpu_torch.utils import pdpickle
    out_main, out_run = tmp / "det-main", tmp / "det-run"
    train = ("--train", "--validate", "--finetune_epochs", "1")
    argv = files_argv(banks, out_main, "detection", *train)
    stats, l_train, ep_main, s_train = files_cli(
        "files-det-train", lambda: cli.main(argv, device="cuda"))
    args = cli.build_parser().parse_args(
        files_argv(banks, out_run, "detection", *train))
    mcfg, _ = cli.configs_from_args(args)
    orig = pdpickle.read_pickle
    pdpickle.read_pickle = twin_read_pickle(fixture)
    try:
        t0 = time.perf_counter()
        splits = cli.load_datasets(args, mcfg, True)
        s_twins = time.perf_counter() - t0
    finally:
        pdpickle.read_pickle = orig
    want, l_run, ep_run, s_run = files_cli(
        "files-det-run", lambda: cli.run(args, *splits, device="cuda"))
    n_train, n_val = (len(ds) for ds in splits)
    require(stats == want and ep_main == ep_run and len(ep_main) == 1,
            f"files-det: cli.main {stats} {ep_main}, cli.run {want} "
            f"{ep_run}")
    a, b = (torch.load(o / "checkpoint.pt", map_location="cpu",
                       weights_only=True)["params"]
            for o in (out_main, out_run))
    require(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                           for k in a),
            "files-det: cli.main's weights differ from cli.run's")
    val_batches = n_val // DET_BATCH
    require_kernel1("files-det-train", l_train, mcfg.num_layers, val_batches)
    require(l_run == l_train, f"files-det: launches {l_train} vs {l_run}")

    argv = files_argv(banks, out_main, "detection", "--extract_feats",
                      "--extract_top_k", str(FILES_TOPK), "--resume",
                      str(out_main))
    dump, l_dump, _, s_dump = files_cli(
        "files-det-dump", lambda: cli.main(argv, device="cuda"))
    require_kernel1("files-det-dump", l_dump, mcfg.num_layers,
                    -(-n_val // DET_BATCH))
    t0 = time.perf_counter()
    result = evals_main([
        "--dump", str(out_main / "dense_predictions.npz"),
        "--gt", os.path.join(TABLES_DIR, FILES_SPLITS["val"][0]),
        "--task", "verb", "--num_classes", str(mcfg.visual_classes[0]),
        "--submission", str(tmp / "verb_submission.json")])
    s_evals = time.perf_counter() - t0
    require(len(result["mAP"]) == 5 and all(
        0.0 <= v <= 1.0 for v in result["mAP"]),
        f"files-evals: {result}")
    log(f"[files-det] cli.main --train --validate: {n_train} train / "
        f"{n_val} val windows, {s_train:.3f} s, train {json.dumps(ep_main)}"
        f", validation {json.dumps(stats)}; cli.run on the twins' splits "
        f"(built in {s_twins:.3f} s) {s_run:.3f} s: losses, statistics "
        f"and weights bit-equal; dump (top-{FILES_TOPK}, "
        f"{len(dump['video_ids'])} rows) {s_dump:.3f} s; evals {s_evals:.3f} "
        f"s: verb mAP {json.dumps(result['mAP'])}, average "
        f"{result['avg_mAP']} (random weights)")
    return ({"files-det-train": l_train, "files-det-run": l_run,
             "files-det-dump": l_dump},
            {"train_s": s_train, "run_s": s_run, "twin_splits_s": s_twins,
             "dump_s": s_dump, "evals_s": s_evals, "train_windows": n_train,
             "val_windows": n_val, "mAP": result["mAP"]})


def files_rec(banks, tmp):
    """27e: ``cli.main --variant recognition --validate`` on the files."""
    from tim_tpu_torch import cli
    argv = files_argv(banks, tmp / "rec", "recognition", "--validate")
    args = cli.build_parser().parse_args(argv)
    mcfg, _ = cli.configs_from_args(args)
    stats, launches, _, secs = files_cli(
        "files-rec-val", lambda: cli.main(argv, device="cuda"))
    require(stats and all(np.isfinite(float(v)) for v in stats.values()),
            f"files-rec-val: statistics {stats}")
    per_batch = launches["query_block_attention"] // mcfg.num_layers
    require(per_batch > 0 and launches["query_block_attention"]
            == per_batch * mcfg.num_layers
            and launches["fused_post_attention"] == 0,
            f"files-rec-val: launches {launches}")
    log(f"[files-rec] cli.main --variant recognition --validate {secs:.3f} "
        f"s ({per_batch} batches of {args.batch_size}), statistics "
        f"{json.dumps(stats)}")
    return launches, {"val_s": secs, "batches": per_batch}


def files_audio(fixture, tmp):
    """27f: ``extract.cli.main --backbone slowfast --audio_dir`` over the
    60 s video of the train feature times (a wav written by
    ``scipy.io.wavfile``), its bank bit-equal to phase 20's direct route
    (``make_audio_apply`` + ``extract_features_for_video`` over the same
    records) with the same SpecAugment draws."""
    import random
    from scipy.io import wavfile
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import extract_features_for_video
    times = os.path.join(TABLES_DIR, FILES_SPLITS["train"][2])
    table = fixture.read_twin(fixture.twin_path(times))
    vid = sorted(table.unique("video_id"))[FILES_AUDIO_SHARD[1]]
    rows = table.where(table["video_id"] == vid).sort_by("start_sec")
    seconds = float(rows["stop_sec"].max()) + 1.0
    wave = np.random.default_rng(SEED + 28).normal(
        scale=0.1, size=int(seconds * AUDIO_SR)).astype(np.float32)
    (tmp / "wav").mkdir()
    wavfile.write(tmp / "wav" / f"{vid}.wav", AUDIO_SR, wave)
    argv = ["--backbone", "slowfast", "--audio_dir", str(tmp / "wav"),
            "--feature_times", times, "--out_dir", str(tmp / "audio"),
            "--split", "train", "--num_aug", str(FILES_AUDIO_NUM_AUG),
            "--batch_size", str(AUDIO_BATCH), "--sampling_rate",
            str(AUDIO_SR), "--num_shards", str(FILES_AUDIO_SHARD[0]),
            "--shard_id", str(FILES_AUDIO_SHARD[1])]
    random.seed(SEED)
    t0 = time.perf_counter()
    ecli.main(argv, device="cuda")
    s_main = time.perf_counter() - t0
    bank = np.load(tmp / "audio" / "train" / f"{vid}.npy")
    args = ecli.build_parser().parse_args(argv)
    random.seed(SEED)
    t0 = time.perf_counter()
    want = extract_features_for_video(
        ecli.audio_clip_fn(wave, rows["start_sec"].astype(np.float64),
                           rows["stop_sec"].astype(np.float64), AUDIO_SR,
                           FILES_AUDIO_NUM_AUG),
        len(rows), FILES_AUDIO_NUM_AUG,
        ecli.make_audio_apply(args, device="cuda"),
        batch_size=AUDIO_BATCH)
    s_direct = time.perf_counter() - t0
    require(bank.shape == want.shape == (len(rows), FILES_AUDIO_NUM_AUG,
                                         2304)
            and np.isfinite(bank).all(),
            f"files-audio: bank {bank.shape}, direct {want.shape}")
    require(bank.tobytes() == want.tobytes(),
            f"files-audio: extract.cli.main's bank differs from the direct "
            f"route by {np.abs(bank - want).max()}")
    log(f"[files-audio] extract.cli.main --backbone slowfast over {vid} "
        f"({len(rows)} records x {FILES_AUDIO_NUM_AUG} sets, {seconds:.1f} "
        f"s wav) {s_main:.3f} s, bank {bank.shape} bit-equal to the direct "
        f"route ({s_direct:.3f} s)")
    return {"main_s": s_main, "direct_s": s_direct, "records": len(rows)}


def phase_files(card: str):
    """Phase 27; returns the launches by path."""
    import pathlib
    import tempfile
    t0 = time.perf_counter()
    fixture = tables_fixture()
    summary = {"card": card, "read": files_read(fixture)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t1 = time.perf_counter()
        nbytes = files_banks(fixture, tmp / "banks")
        summary["banks"] = {"bytes": nbytes,
                            "write_s": time.perf_counter() - t1}
        paths, summary["detection"] = files_det(fixture, tmp / "banks", tmp)
        paths["files-rec-val"], summary["recognition"] = files_rec(
            tmp / "banks", tmp)
        summary["audio"] = files_audio(fixture, tmp)
    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("pandas", "pyarrow"))
    require(not loaded, f"files: loaded {loaded}")
    summary["seconds"] = time.perf_counter() - t0
    log(f"[files] summary {json.dumps(summary)}; neither pandas nor pyarrow "
        f"loaded; {summary['seconds']:.2f} s (the phase's limit is 60 s)")
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# Phase 28: --audio_hdf5 on the card's machine, which has no h5py: the
# port's reader (utils.hdf5) on tests/data/torch_hdf5, whose .npz twins
# (numpy alone) say what each file holds.
# ---------------------------------------------------------------------------
HDF5_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "torch_hdf5")
HDF5_LIMIT_S = 30.0


def hdf5_fixture():
    """``tests/data/torch_hdf5/make_fixture.py`` as a module (numpy alone
    at import: ``read_twin``, the file names, the waveforms)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_hdf5_fixture", os.path.join(HDF5_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hdf5_walk(group, out, prefix="/"):
    """Every dataset a walk of the reader's groups reaches, by path."""
    from tim_tpu_torch.utils import hdf5
    for key in group.keys():
        obj = group[key]
        if isinstance(obj, hdf5.Group):
            hdf5_walk(obj, out, prefix + key + "/")
        else:
            out[prefix + key] = obj
    return out


def hdf5_read(fixture):
    """28a: every dataset of the three files read by ``utils.hdf5`` and
    held to its twin: the same paths, dtype, shape and bytes."""
    from tim_tpu_torch.utils import hdf5
    out = {}
    for name in fixture.H5_FILES:
        path = os.path.join(HDF5_DIR, name)
        twins = fixture.read_twin(path)
        t0 = time.perf_counter()
        with hdf5.File(path) as f:
            arrays = {k: d.read() for k, d in hdf5_walk(f, {}).items()}
        secs = time.perf_counter() - t0
        require(sorted(arrays) == sorted(twins),
                f"hdf5-read: {name} holds {sorted(arrays)}, its twin "
                f"{sorted(twins)}")
        for key, want in twins.items():
            got = arrays[key]
            require(got.dtype == want.dtype and got.shape == want.shape
                    and got.tobytes() == want.tobytes(),
                    f"hdf5-read: {name}{key} differs from its twin")
        nbytes = sum(a.nbytes for a in arrays.values())
        out[name] = {"file_bytes": os.path.getsize(path),
                     "data_bytes": nbytes, "datasets": len(arrays),
                     "read_s": secs, "MB_per_s": rate(nbytes, secs)}
        log(f"[hdf5-read] {name}: {len(arrays)} datasets, {nbytes} bytes of "
            f"data ({out[name]['file_bytes']} in the file) read in "
            f"{secs:.6f} s ({out[name]['MB_per_s']:.1f} MB/s), each "
            f"bit-equal to its twin")
    return out


def hdf5_extract(fixture, tmp):
    """28b: ``extract.cli.main --backbone slowfast --audio_hdf5`` over the
    fixture's three waveforms at full width, its banks bit-equal to the
    ``--audio_dir`` route over float32 WAVs of the twins' samples, both
    under the same ``random.seed``. Returns (launches, numbers)."""
    import random
    from scipy.io import wavfile
    from tim_tpu_torch.extract import cli as ecli
    epic = os.path.join(HDF5_DIR, "epic_audio.h5")
    twins = fixture.read_twin(epic)
    (tmp / "wav").mkdir()
    for vid in fixture.WAVEFORMS:
        wavfile.write(tmp / "wav" / f"{vid}.wav", fixture.SAMPLING_RATE,
                      twins["/" + vid])
    common = ["--backbone", "slowfast", "--feature_times",
              os.path.join(HDF5_DIR, "feature_times.pkl"), "--split", "val",
              "--num_aug", "2", "--batch_size", str(AUDIO_BATCH),
              "--sampling_rate", str(fixture.SAMPLING_RATE)]
    sources = {"hdf5": ["--audio_hdf5", epic],
               "wav": ["--audio_dir", str(tmp / "wav")]}
    seconds = {"hdf5": [], "wav": []}
    launches = None
    for i, route in enumerate(("hdf5", "wav", "wav", "hdf5")):  # in turns
        random.seed(SEED)
        counters = zero_counts()
        t0 = time.perf_counter()
        ecli.main(common + sources[route]
                  + ["--out_dir", str(tmp / f"{route}{i}")], device="cuda")
        torch.cuda.synchronize()
        seconds[route].append(time.perf_counter() - t0)
        if i == 0:
            launches = read_counts(counters)
    clips = 0
    for vid in fixture.WAVEFORMS:
        got, *others = (np.load(tmp / out / "val" / f"{vid}.npy")
                        for out in ("hdf50", "wav1", "wav2", "hdf53"))
        require(got.shape[1:] == (2, 2304) and np.isfinite(got).all(),
                f"hdf5-audio: {vid} bank {got.shape}")
        for want in others:
            require(got.shape == want.shape and got.tobytes()
                    == want.tobytes(),
                    f"hdf5-audio: {vid}: the --audio_hdf5 bank differs from "
                    f"another run's (--audio_dir's or its own)")
        clips += got.shape[0] * got.shape[1]
    require(not any(launches.values()),
            f"hdf5-audio: SlowFast in fp32 launches no kernel: {launches}")
    rates = {route: [clips / t for t in ts] for route, ts in seconds.items()}
    log(f"[hdf5-audio] extract.cli.main over {len(fixture.WAVEFORMS)} "
        f"waveforms ({clips} clips, num_aug 2, batch {AUDIO_BATCH}), in "
        f"turns hdf5, wav, wav, hdf5: --audio_hdf5 {seconds['hdf5']} s "
        f"({rates['hdf5']} wall clips/s), --audio_dir {seconds['wav']} s "
        f"({rates['wav']} clips/s); the four banks bit-equal; launches "
        f"{launches}")
    return launches, {"clips": clips, "hdf5_s": seconds["hdf5"],
                      "wav_s": seconds["wav"],
                      "hdf5_clips_per_s": rates["hdf5"],
                      "wav_clips_per_s": rates["wav"]}


def hdf5_controls(tmp):
    """28c: a flipped byte in a dataset's ``OHDR`` (the latest-format file)
    and the EPIC file cut inside a waveform must be refused, each error
    naming the structure."""
    from tim_tpu_torch.utils import hdf5
    src = os.path.join(HDF5_DIR, "layouts_latest.h5")
    with hdf5.File(src) as f:
        _, addr = f["index"]._find("fixed_paged")
    data = bytearray(open(src, "rb").read())
    data[addr + 30] ^= 0x10
    (tmp / "flipped.h5").write_bytes(bytes(data))
    epic = os.path.join(HDF5_DIR, "epic_audio.h5")
    with hdf5.File(epic) as f:
        wave = f["P30_10"]
        cut = wave._address + wave.dtype.itemsize * wave.shape[0] // 2
    (tmp / "cut.h5").write_bytes(open(epic, "rb").read()[:cut])
    out = {}
    for tag, path, name, kind, words in (
            ("flipped-ohdr", tmp / "flipped.h5", "index/fixed_paged",
             ValueError, ("OHDR of /index/fixed_paged", "checksum mismatch")),
            ("cut-waveform", tmp / "cut.h5", "P30_10", OSError,
             ("truncated", "end-of-file address"))):
        try:
            with hdf5.File(path) as f:
                np.asarray(f[name], np.float32)
        except kind as e:
            msg = str(e)
        else:
            msg = None
        require(msg is not None and all(w in msg for w in words),
                f"hdf5-controls: {tag} was not refused as expected: {msg}")
        out[tag] = msg
        log(f"[hdf5-controls] {tag}: refused: {msg}")
    return out


def phase_hdf5(card: str):
    """Phase 28; returns the launches by path."""
    import pathlib
    import tempfile
    t0 = time.perf_counter()
    fixture = hdf5_fixture()
    summary = {"card": card, "read": hdf5_read(fixture)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        launches, summary["audio"] = hdf5_extract(fixture, tmp)
        summary["controls"] = hdf5_controls(tmp)
    require(sys.modules.get("h5py") is None, "hdf5: h5py was imported")
    import importlib.util
    summary["h5py_installed"] = importlib.util.find_spec("h5py") is not None
    summary["seconds"] = time.perf_counter() - t0
    log(f"[hdf5] summary {json.dumps(summary)}; h5py not loaded; "
        f"{summary['seconds']:.2f} s (limit {HDF5_LIMIT_S:.0f} s)")
    require(summary["seconds"] <= HDF5_LIMIT_S,
            f"hdf5: {summary['seconds']:.2f} s, past its limit")
    torch.cuda.empty_cache()
    return {"hdf5-audio": launches}


# ---------------------------------------------------------------------------
# Phase 29: JPEG frames and the uint8 resizes without PIL or cv2: the port's
# decoder (utils.jpeg over csrc/host/jpeg.cc) and resizes (extract.image) on
# tests/data/torch_jpeg, whose .npz twins (numpy alone) hold the SHA-256 of
# Pillow's and cv2's decodes and of both resizes of each file.
# ---------------------------------------------------------------------------
JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "torch_jpeg")
# in a whole smoke run the phase took 19.85 s; alone from a fresh checkout
# (the host library's g++ build and kernels 4 and 5 built in it) 17.5-36.4
# s, the hosts' CPU rates differing 2.2x between calls
JPEG_LIMIT_S = 40.0
JPEG_BATCH = 4
# backbone -> (frames a clip, the kernel its attention launches)
JPEG_BACKBONES = {"omnivore": (32, "window_attention"),
                  "videomae": (16, "flash_mha")}


def jpeg_fixture():
    """``tests/data/torch_jpeg/make_fixture.py`` as a module (numpy alone
    at import: ``read_twin``, ``digest``, the file names)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_fixture", os.path.join(JPEG_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seconds(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def jpeg_read(fixture):
    """29a: every fixture file decoded without and with the Exif
    orientation, and Pillow's and cv2's resizes of the first decode at the
    transforms' sizes, each held to its twin's digest; the EPIC frames'
    decode rate (one ``read_jpegs`` call) and both resizes' rate at 256 x
    456 -> 224, one pass each over warm files. Returns ({path: (plain,
    oriented)}, numbers)."""
    from tim_tpu_torch.extract.image import (
        resize_cv2_linear_u8, resize_pil_bilinear_u8)
    from tim_tpu_torch.utils.jpeg import library, read_jpeg, read_jpegs
    t0 = time.perf_counter()
    library()           # g++ builds it here on a fresh checkout
    build_s = time.perf_counter() - t0
    decoded = {}
    t0 = time.perf_counter()
    for path in fixture.jpeg_files():
        twin = fixture.read_twin(path)
        plain = read_jpeg(path, apply_orientation=False)
        oriented = read_jpeg(path, apply_orientation=True)
        width, height = fixture.pil_resize_size(*plain.shape[:2])
        s = fixture.cv2_scale(plain.shape[0])
        got = {"pil": plain, "cv2": oriented,
               "pil_resize": resize_pil_bilinear_u8(plain[None], width,
                                                    height)[0],
               "cv2_resize": resize_cv2_linear_u8(plain[None], s, s)[0]}
        for key in fixture.TWIN_KEYS:
            require(fixture.digest(got[key]) == twin[key],
                    f"jpeg-read: {os.path.relpath(path, JPEG_DIR)}: {key} "
                    f"{fixture.digest(got[key])} differs from its twin "
                    f"{twin[key]}")
        decoded[path] = (plain, oriented)
    check_s = time.perf_counter() - t0
    epic = [p for ps in fixture.frame_paths().values() for p in ps]
    decode_s = seconds(lambda: read_jpegs(epic, apply_orientation=False))
    frames = np.stack([decoded[p][0] for p in epic])
    width, height = fixture.pil_resize_size(*frames.shape[1:3])
    s = fixture.cv2_scale(frames.shape[1])
    pil_s = seconds(lambda: resize_pil_bilinear_u8(frames, width, height))
    cv2_s = seconds(lambda: resize_cv2_linear_u8(frames, s, s))
    numbers = {
        "library_s": build_s, "files": len(decoded), "check_s": check_s,
        "epic_frames": len(epic), "epic_jpeg_bytes": sum(
            os.path.getsize(p) for p in epic),
        "decode_frames_per_s": len(epic) / decode_s,
        "resize_pil_frames_per_s": len(epic) / pil_s,
        "resize_cv2_frames_per_s": len(epic) / cv2_s}
    log(f"[jpeg-read] the host library built and loaded in {build_s:.3f} s; "
        f"{len(decoded)} files: both decodes and both resizes "
        f"bit-equal to their twins ({check_s:.3f} s); EPIC 456 x 256 4:2:0 "
        f"frames ({len(epic)}, {numbers['epic_jpeg_bytes']} bytes): "
        f"decode {numbers['decode_frames_per_s']:.1f} frames/s; resizes to "
        f"224: Pillow's BILINEAR "
        f"{numbers['resize_pil_frames_per_s']:.1f} frames/s, cv2's "
        f"INTER_LINEAR {numbers['resize_cv2_frames_per_s']:.1f} frames/s")
    return decoded, numbers


def jpeg_extract(fixture, decoded, tmp):
    """29b: ``extract.cli.main --backbone omnivore|videomae`` (full width,
    bf16, ``--num_aug 1``) over the fixture's EPIC frame directories, twice
    each (the first run builds the backbone, which the second reuses), each
    bank bit-equal to ``extract_features_for_video`` over the twin-checked
    decodes through the port's transforms. The host's part of a run: the
    transforms timed in the twins' route, and each clip's distinct frames
    decoded again alone with ``read_jpegs``. Returns (launches by path,
    numbers, and for phase 30: the built backbones by name, which stay
    built, the twins' banks by (name, video) and their clips by (name,
    video, row))."""
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import (
        extract_features_for_video, omnivore_frame_indices,
        omnivore_test_transform, preprocess_video_clip)
    from tim_tpu_torch.utils.jpeg import read_jpegs
    from tim_tpu_torch.utils.pdpickle import read_pickle

    times = os.path.join(JPEG_DIR, "feature_times.pkl")
    table = read_pickle(times)
    built, real = {}, ecli.make_visual_apply

    def reuse(args, device=None):
        if args.backbone not in built:
            built[args.backbone] = real(args, device)
        return built[args.backbone]

    paths, numbers, banks, clean = {}, {}, {}, {}
    ecli.make_visual_apply = reuse
    try:
        for name, (num_frames, kernel) in JPEG_BACKBONES.items():
            argv = ["--backbone", name, "--frames_dir",
                    os.path.join(JPEG_DIR, "frames"), "--feature_times",
                    times, "--split", "val", "--num_frames", str(num_frames),
                    "--batch_size", str(JPEG_BATCH)]
            walls = []
            for run in range(2):
                counters = zero_counts()
                t0 = time.perf_counter()
                ecli.main(argv + ["--out_dir", str(tmp / f"{name}{run}")],
                          device="cuda")
                launches = read_counts(counters)
                walls.append(time.perf_counter() - t0)
            apply_fn, clips, forwards = built[name], 0, 0
            host = {"decode_s": 0.0, "transform_s": 0.0}
            for vid, files in fixture.frame_paths().items():
                video = np.stack([decoded[p][0] for p in files])
                rows = table.where(table["video_id"] == vid).sort_by(
                    "start_sec")
                starts, stops = rows["start_frame"], rows["stop_frame"]

                def clip_fn(t, a, video=video, starts=starts, stops=stops,
                            files=files):
                    idx = omnivore_frame_indices(
                        int(stops[t]) - int(starts[t]), int(starts[t]),
                        len(video), num_frames)
                    t0 = time.perf_counter()
                    read_jpegs([files[i - 1] for i in np.unique(idx)],
                               apply_orientation=False)
                    t1 = time.perf_counter()
                    frames = video[idx - 1]
                    if name == "omnivore":
                        clip = omnivore_test_transform(frames[..., ::-1],
                                                       size=224)
                    else:
                        clip = preprocess_video_clip(frames, size=224)
                    host["decode_s"] += t1 - t0
                    host["transform_s"] += time.perf_counter() - t1
                    clean[(name, vid, t)] = clip
                    return clip

                want = extract_features_for_video(
                    clip_fn, len(rows), 1, apply_fn, batch_size=JPEG_BATCH)
                banks[(name, vid)] = want
                require(want.shape == (len(rows), 1, 1024)
                        and bool(np.isfinite(want).all()),
                        f"jpeg-extract-{name}: {vid} bank {want.shape} or "
                        f"non-finite")
                for run in range(2):
                    got = np.load(tmp / f"{name}{run}" / "val" / f"{vid}.npy")
                    require(got.shape == want.shape
                            and got.tobytes() == want.tobytes(),
                            f"jpeg-extract-{name}: {vid}: run {run}'s bank "
                            f"differs from the twins' route")
                clips += len(rows)
                forwards += -(-len(rows) // JPEG_BATCH)
            require(launches[kernel] == 24 * forwards
                    and attention_launches(launches) == launches[kernel],
                    f"jpeg-extract-{name}: launches {launches}, expected 24 "
                    f"x {forwards} of {kernel}")
            paths[f"jpeg-extract-{name}"] = launches
            numbers[name] = {"clips": clips, "forwards": forwards,
                             "first_run_s": walls[0], "wall_s": walls[1],
                             "wall_clips_per_s": clips / walls[1], **host}
            log(f"[jpeg-extract-{name}] extract.cli.main over "
                f"{len(fixture.VIDEOS)} EPIC frame directories, {clips} "
                f"clips of {num_frames} frames, bf16, batch {JPEG_BATCH}: "
                f"first run (with the backbone's build) {walls[0]:.3f} s, "
                f"second {walls[1]:.3f} s ({clips / walls[1]:.2f} wall "
                f"clips/s; the host's decode {host['decode_s']:.3f} s and "
                f"transforms {host['transform_s']:.3f} s, timed in the "
                f"twins' route); both banks bit-equal to the twins' route; "
                f"launches of the second {launches} ({forwards} forwards, "
                f"{launches[kernel] / forwards:.0f} of {kernel} each)")
    finally:
        ecli.make_visual_apply = real
    return paths, numbers, built, banks, clean


def jpeg_clips(fixture, decoded):
    """29c: ``jpeg_frame_reader`` + ``EK100ClipDataset(mode="validation")``
    at the finetune CLI's clip size gives the clips of a reader over the
    twin-checked (oriented) decodes, bit for bit."""
    from tim_tpu_torch.extract.clips import EK100ClipDataset, jpeg_frame_reader
    files = fixture.frame_paths()

    def twins(video_id, indices, offset):
        return np.stack([decoded[files[video_id][int(i) + offset]][1]
                         for i in indices])

    annotations = {"video_id": np.asarray(["P01_01", "P02_03", "P01_01"]),
                   "start_frame": np.asarray([0, 1, 4]),
                   "stop_frame": np.asarray([12, 10, 9]),
                   "verb_class": np.asarray([3, 1, 2]),
                   "noun_class": np.asarray([7, 0, 4])}
    kw = dict(annotations=annotations, mode="validation", num_frames=16,
              crop_size=224, rand_augment=lambda f: f)
    port = EK100ClipDataset(frame_reader=jpeg_frame_reader(
        os.path.join(JPEG_DIR, "frames"), "frame_{:010d}.jpg"), **kw)
    ref = EK100ClipDataset(frame_reader=twins, **kw)
    t0 = time.perf_counter()
    items = [port[i] for i in range(len(annotations["video_id"]))]
    secs = time.perf_counter() - t0
    for i, got in enumerate(items):
        want = ref[i]
        require(sorted(got) == sorted(want) and all(
            np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
            for k in want), f"jpeg-clips: item {i} differs from the twins'")
    log(f"[jpeg-clips] jpeg_frame_reader + EK100ClipDataset(validation, 16 x "
        f"224^2): {len(items)} clips {items[0]['video'].shape} bit-equal to "
        f"the twins' route ({secs:.3f} s)")
    return {"clips": len(items), "seconds": secs}


def jpeg_controls(fixture, tmp):
    """29d: the first EPIC frame cut in half, and with the byte at
    ``fixture.FLIP_OFFSET`` inside its scan flipped, each refused with the
    offset named."""
    from tim_tpu_torch.utils.jpeg import read_jpeg
    src = fixture.frame_paths()["P01_01"][0]
    with open(src, "rb") as f:
        data = f.read()
    flipped = bytearray(data)
    flipped[fixture.FLIP_OFFSET] ^= 0xFF
    out = {}
    for tag, blob, words in (
            ("truncated", data[:len(data) // 2], ("truncated", "byte offset")),
            ("flipped", bytes(flipped), ("marker", "byte offset"))):
        path = tmp / f"{tag}.jpg"
        path.write_bytes(blob)
        try:
            read_jpeg(str(path), apply_orientation=False)
        except ValueError as e:
            msg = str(e)
        else:
            msg = None
        require(msg is not None and all(w in msg for w in words),
                f"jpeg-controls: the {tag} frame was not refused as expected:"
                f" {msg}")
        out[tag] = msg
        log(f"[jpeg-controls] {tag}: refused: {msg}")
    return out


JPEG_COMPARE = r'''
import importlib.util, json, os, sys, time
import numpy as np
import cv2
import PIL
from PIL import Image, features
from tim_tpu_torch.extract import image as I
from tim_tpu_torch.utils import jpeg as J

root = sys.argv[1]
spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(root, "make_fixture.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)


def diff(a, b):
    return -1 if a.shape != b.shape else int((a != b).sum())


out = {"cv2": cv2.__version__, "PIL": PIL.__version__,
       "libjpeg_turbo": features.version("libjpeg_turbo"),
       "cv2_threads": cv2.getNumThreads(), "files": {}}
for path in fx.jpeg_files():
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    cv = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    w, h = fx.pil_resize_size(*pil.shape[:2])
    s = fx.cv2_scale(pil.shape[0])
    out["files"][os.path.relpath(path, root)] = {
        "pil": diff(J.read_jpeg(path, apply_orientation=False), pil),
        "cv2": diff(J.read_jpeg(path, apply_orientation=True), cv),
        "pil_resize": diff(I.resize_pil_bilinear_u8(pil[None], w, h)[0],
                           np.asarray(Image.fromarray(pil).resize(
                               (w, h), Image.BILINEAR))),
        "cv2_resize": diff(I.resize_cv2_linear_u8(pil[None], s, s)[0],
                           cv2.resize(pil, (0, 0), fx=s, fy=s))}
# row tails: every output row width from 1 to 80 pixels (3 to 240 bytes)
# and some wider, at the transform's scale, an upscale and cv2's 2x route
rng = np.random.default_rng(0)
tails = {"cases": 0, "mismatched_values": 0, "mismatched_cases": []}
for w in list(range(1, 81)) + [127, 128, 129, 255, 341, 399, 455, 456, 457]:
    for h, f in ((256, 224 / 256), (37, 1.7), (64, 0.5)):
        if round(w * f) < 1:
            continue
        a = rng.integers(0, 256, (1, h, w, 3), np.uint8)
        n = diff(I.resize_cv2_linear_u8(a, f, f)[0],
                 cv2.resize(a[0], (0, 0), fx=f, fy=f))
        tails["cases"] += 1
        if n:
            tails["mismatched_values"] += max(n, 0)
            tails["mismatched_cases"].append([h, w, f, n])
out["cv2_row_tails"] = tails


def rate(fn, items):
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    return len(items) / (time.perf_counter() - t0)


epic = [p for ps in fx.frame_paths().values() for p in ps]
out["decode_frames_per_s"] = {
    "pil": rate(lambda p: np.asarray(Image.open(p).convert("RGB")), epic),
    "cv2": rate(lambda p: cv2.imread(p, cv2.IMREAD_COLOR), epic),
    "port": rate(lambda p: J.read_jpeg(p, apply_orientation=False), epic)}
frames = [J.read_jpeg(p, apply_orientation=False) for p in epic]
w, h = fx.pil_resize_size(*frames[0].shape[:2])
s = fx.cv2_scale(frames[0].shape[0])
out["resize_frames_per_s"] = {
    "pil": rate(lambda a: Image.fromarray(a).resize((w, h), Image.BILINEAR),
                frames),
    "port_pil": rate(lambda a: I.resize_pil_bilinear_u8(a[None], w, h),
                     frames),
    "cv2": rate(lambda a: cv2.resize(a, (0, 0), fx=s, fy=s), frames),
    "port_cv2": rate(lambda a: I.resize_cv2_linear_u8(a[None], s, s),
                     frames)}
print(json.dumps(out))
'''


def jpeg_compare():
    """29e, where the card's machine has PIL and cv2: in a subprocess (so
    that this process never loads them), Pillow's and cv2's decodes and
    resizes of every fixture file against the port's, cv2's row tails over
    a grid of widths, and the three decoders' and the resizes' frames/s
    one frame at a time."""
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    if not all(have.values()):
        log(f"[jpeg-compare] skipped: the machine lacks {have}")
        return {"skipped": have}
    run = subprocess.run(
        [sys.executable, "-c", JPEG_COMPARE, JPEG_DIR], capture_output=True,
        text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    require(run.returncode == 0, f"jpeg-compare failed:\n{run.stderr[-3000:]}")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    bad = {f: m for f, m in out["files"].items() if any(m.values())}
    tails = out["cv2_row_tails"]
    log(f"[jpeg-compare] PIL {out['PIL']} (libjpeg-turbo "
        f"{out['libjpeg_turbo']}), cv2 {out['cv2']} ({out['cv2_threads']} "
        f"threads): {len(out['files'])} files, mismatches per file "
        f"(decodes and resizes) {json.dumps(bad) if bad else 'none'}; cv2 "
        f"row tails: {tails['cases']} resizes, {tails['mismatched_values']} "
        f"values differ {tails['mismatched_cases'][:10]}")
    d, r = out["decode_frames_per_s"], out["resize_frames_per_s"]
    log(f"[jpeg-compare] EPIC frames one at a time: decode frames/s PIL "
        f"{d['pil']:.1f}, cv2 {d['cv2']:.1f}, port {d['port']:.1f}; resize "
        f"to 224 frames/s PIL {r['pil']:.1f} vs port {r['port_pil']:.1f}, "
        f"cv2 {r['cv2']:.1f} vs port {r['port_cv2']:.1f}")
    require(not bad and not tails["mismatched_values"],
            f"jpeg-compare: the port differs from PIL or cv2: {bad}, "
            f"{tails['mismatched_cases']}")
    return out


def phase_jpeg(card: str):
    """Phase 29; returns the launches by path and what phase 30 reuses:
    the fixture module, the decodes, the built backbones, the twins' banks
    and clips."""
    import pathlib
    import tempfile
    t0 = time.perf_counter()
    before = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2"))
    require(not before, f"jpeg: PIL or cv2 loaded before phase 29: {before}")
    fixture = jpeg_fixture()
    parts, mark = {}, time.perf_counter()

    def lap(part):
        nonlocal mark
        now = time.perf_counter()
        parts[part], mark = now - mark, now

    decoded, summary = jpeg_read(fixture)
    summary = {"card": card, "read": summary, "part_seconds": parts}
    lap("a")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        paths, summary["extract"], built, banks, clean = jpeg_extract(
            fixture, decoded, tmp)
        lap("b")
        summary["clips"] = jpeg_clips(fixture, decoded)
        summary["controls"] = jpeg_controls(fixture, tmp)
        lap("c_d")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2"))
    require(not loaded, f"jpeg: PIL or cv2 was imported: {loaded}")
    summary["seconds_a_to_d"] = time.perf_counter() - t0
    compare = jpeg_compare()
    lap("e")
    files = compare.pop("files", {})
    summary["compare"] = dict(compare, files=len(files), mismatched_files={
        f: m for f, m in files.items() if any(m.values())})
    summary["seconds"] = time.perf_counter() - t0
    log(f"[jpeg] summary {json.dumps(summary)}; neither PIL nor cv2 loaded "
        f"in a-d; {summary['seconds']:.2f} s (limit {JPEG_LIMIT_S:.0f} s)")
    require(summary["seconds"] <= JPEG_LIMIT_S,
            f"jpeg: {summary['seconds']:.2f} s, past its limit")
    return paths, {"fixture": fixture, "decoded": decoded, "built": built,
                   "banks": banks, "clean": clean}


# ---------------------------------------------------------------------------
# Phase 30: RandAugment without PIL: Pillow's ops of the port's own
# (extract/imageops.py; the affine resample and the SMOOTH filter as C++
# loops in csrc/host/imageops.cc, in phase 29's host library) under the
# augmentation sets of visual extraction and the finetune clips, on
# tests/data/torch_autoaug, whose digests.json (numpy alone reads it) holds
# the SHA-256 of Pillow's results.
# ---------------------------------------------------------------------------
AUTOAUG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "torch_autoaug")
AUTOAUG_LIMIT_S = 40.0
AUTOAUG_SEED = SEED + 30
AUTOAUG_FILL = [124, 116, 104]           # the ImageNet mean's fill
# (class, imageops function, arguments after the frames): the ops whose
# frames/s 30a prints, each over phase 29's EPIC frames in one call (30e
# beside Pillow's)
AUTOAUG_RATE_OPS = (
    ("point", "autocontrast", []), ("point", "equalize", []),
    ("point", "invert", []), ("point", "posterize", [2]),
    ("point", "solarize", [128]), ("point", "solarize_add", [55]),
    ("enhance", "color", [1.45]), ("enhance", "contrast", [0.55]),
    ("enhance", "brightness", [1.45]), ("enhance", "sharpness", [0.55]),
    ("affine_bicubic", "rotate", [15.0, 3, AUTOAUG_FILL]),
    ("affine_bicubic", "affine", [[1, 0.3, 0, 0, 1, 0], 3, AUTOAUG_FILL]),
    ("affine_bicubic", "affine", [[1, 0, 102.6, 0, 1, 0], 3, AUTOAUG_FILL]),
)


def autoaug_fixture():
    """``tests/data/torch_autoaug/make_fixture.py`` as a module (numpy
    alone: the cases, ``run_case``, ``digest``, ``read_digests``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_autoaug_fixture", os.path.join(AUTOAUG_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same(got, want) -> bool:
    """The phase's comparison: the same shape, dtype and bytes."""
    got, want = np.asarray(got), np.asarray(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and got.tobytes() == want.tobytes())


class PlainTwins:
    """``imageops.affine`` and ``imageops.smooth`` swapped for their numpy
    twins while inside, each frame of a clip computed once for a given
    frame and arguments (both are pure functions of them; a clip repeats
    its frames)."""

    def __enter__(self):
        import hashlib
        from tim_tpu_torch.extract import imageops
        self.module = imageops
        self.saved = (imageops.affine, imageops.smooth)
        cache = {}

        def per_frame(plain):
            def run(img, *args):
                clip = imageops.as_frames(img)
                frames = clip[None] if clip.ndim == 3 else clip
                out = []
                for f in frames:
                    f = np.ascontiguousarray(f)
                    key = (plain.__name__, f.shape,
                           hashlib.sha1(f.tobytes()).hexdigest(), repr(args))
                    if key not in cache:
                        cache[key] = plain(f, *args)
                    out.append(cache[key])
                return out[0] if clip.ndim == 3 else np.stack(out)
            return run

        imageops.affine = per_frame(imageops.affine_plain)
        imageops.smooth = per_frame(imageops.smooth_plain)
        return self

    def __exit__(self, *exc):
        self.module.affine, self.module.smooth = self.saved


def block_modules(names):
    """``import`` of each of ``names`` raises until ``unblock_modules``;
    returns what ``sys.modules`` held for them."""
    saved = {name: sys.modules.get(name) for name in names}
    for name in names:
        sys.modules[name] = None
    return saved


def unblock_modules(saved):
    for name, module in saved.items():
        if module is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = module


def autoaug_rates(clip):
    """Frames/s of each op of ``AUTOAUG_RATE_OPS`` over ``clip`` in one
    call, and of each class (its frames over its ops' summed seconds)."""
    from tim_tpu_torch.extract import imageops
    ops, classes = {}, {}
    for cls, name, args in AUTOAUG_RATE_OPS:
        fn = getattr(imageops, name)
        secs = seconds(lambda: fn(clip, *args))
        ops[f"{name}{args}"] = len(clip) / secs
        n, s = classes.get(cls, (0, 0.0))
        classes[cls] = (n + len(clip), s + secs)
    return ops, {cls: n / s for cls, (n, s) in classes.items()}


def autoaug_ops(fx, jpeg_fixture, decoded):
    """30a: every case of the fixture (each op at each magnitude, resample
    and fill on three EPIC frames and two odd ones; the two clip front
    doors) held to its digest; each C++ loop held to its numpy twin on an
    EPIC frame; frames/s of each op class over the 22 EPIC frames."""
    from tim_tpu_torch.extract import autoaug
    from tim_tpu_torch.extract import imageops as O
    want = fx.read_digests()
    frames = fx.frames(lambda p: decoded[p][0])
    t0 = time.perf_counter()
    bad = [c["key"] for c in fx.cases()
           if fx.digest(fx.run_case(autoaug, frames[c["frame"]], c))
           != want["digests"][c["key"]]]
    single_s = time.perf_counter() - t0
    epic = [decoded[p][0] for ps in jpeg_fixture.frame_paths().values()
            for p in ps]
    t0 = time.perf_counter()
    for key, door, seed in fx.clip_cases():
        out = fx.run_clip(autoaug, epic, door, seed)
        if (out.shape != want["shapes"][key]
                or fx.digest(out) != want["digests"][key]):
            bad.append(key)
    clips_s = time.perf_counter() - t0
    require(not bad, f"autoaug-ops: {len(bad)} cases differ from Pillow's "
            f"digests: {bad[:10]}")
    # the C++ loops against their numpy twins, on each route
    frame = frames["epic0"]
    h, w = frame.shape[:2]
    matrices = {"shear_x": (1, 0.3, 0, 0, 1, 0),
                "shear_y": (1, 0, 0, -0.3, 1, 0),
                "translate_x": (1, 0, 0.45 * w, 0, 1, 0),
                "rotate_30": tuple(O.rotation_matrix(w, h, 30.0)),
                "general": (0.9, -0.4, 5.5, 0.35, 1.1, -6.0)}
    twins = 0
    t0 = time.perf_counter()
    for name, m in matrices.items():
        for resample in (O.NEAREST, O.BILINEAR, O.BICUBIC):
            require(same(O.affine(frame, m, resample, AUTOAUG_FILL),
                         O.affine_plain(frame, m, resample, AUTOAUG_FILL)),
                    f"autoaug-ops: affine {name} at {resample} differs "
                    f"from affine_plain")
            twins += 1
    three = np.stack([frames[k] for k in fx.EPIC_FRAMES])
    require(same(O.smooth(three), O.smooth_plain(three)),
            "autoaug-ops: smooth differs from smooth_plain")
    twins_s = time.perf_counter() - t0
    rates, classes = autoaug_rates(np.stack(epic))
    numbers = {"cases": len(want["digests"]), "single_op_s": single_s,
               "clip_cases_s": clips_s, "twin_checks": twins + 1,
               "twins_s": twins_s, "frames_per_s": classes,
               "op_frames_per_s": rates, "pillow_of_fixture": want["pillow"]}
    log(f"[autoaug-ops] {len(want['digests'])} fixture cases (Pillow "
        f"{want['pillow']}) bit-equal to their digests ({single_s:.3f} s "
        f"the single ops, {clips_s:.3f} s the {len(fx.clip_cases())} clip "
        f"front doors); affine at 5 matrices x 3 resamples and smooth of 3 "
        f"EPIC frames bit-equal to their numpy twins ({twins_s:.3f} s); "
        f"frames/s over {len(epic)} EPIC 456 x 256 frames, one call an op: "
        + ", ".join(f"{k} {v:.1f}" for k, v in classes.items()))
    return numbers


def autoaug_twin_clips(name, num_frames, argv, out_dir):
    """The set-1 clips of the numpy twins' route, in the CLI's order (a
    worker process of 30b): for each video (sorted) and row, the clip
    function's frames of the twin-checked decodes
    (``out_dir/<video>.npy``), augmented by the CLI's RandAugment with
    ``imageops``' C++ loops swapped for their numpy twins, then
    transformed; ``random`` and ``np.random`` seeded as before the CLI's
    run. Each clip is saved to ``out_dir/<video>_<row>.npy``."""
    import random
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import (
        omnivore_frame_indices, omnivore_test_transform,
        preprocess_video_clip)
    from tim_tpu_torch.utils.pdpickle import read_pickle
    table = read_pickle(os.path.join(JPEG_DIR, "feature_times.pkl"))
    with PlainTwins():
        random.seed(AUTOAUG_SEED)
        np.random.seed(AUTOAUG_SEED)
        ra = ecli.rand_augment(ecli.build_parser().parse_args(argv))
        for vid in sorted(table.unique("video_id").tolist()):
            video = np.load(os.path.join(out_dir, f"{vid}.npy"))
            rows = table.where(table["video_id"] == vid).sort_by("start_sec")
            starts, stops = rows["start_frame"], rows["stop_frame"]
            for t in range(len(rows)):
                idx = omnivore_frame_indices(
                    int(stops[t]) - int(starts[t]), int(starts[t]),
                    len(video), num_frames)
                frames = video[idx - 1]
                if name == "omnivore":
                    clip = omnivore_test_transform(ra(frames[..., ::-1]),
                                                   size=224, input_bgr=True)
                else:
                    clip = preprocess_video_clip(ra(frames), size=224)
                np.save(os.path.join(out_dir, f"{vid}_{t}.npy"), clip)


def autoaug_extract(jpeg_fixture, state, tmp):
    """30b: ``extract.cli.main --num_aug 2`` for Swin-B and ViT-L (full
    width, bf16, batch 4) over phase 29's EPIC frame directories, with
    ``random`` and ``np.random`` seeded; set 0 of each bank bit-equal to
    phase 29's bank, set 1 to ``extract_features_for_video`` over the
    twin-checked decodes augmented by the numpy twins under the same seeds
    (``autoaug_twin_clips``, one worker process a backbone, both started
    first and run beside the CLIs; set 0 there: phase 29's twins' clips),
    in the CLI's batches. Returns (launches by path, numbers, the CLI's
    banks by (name, video))."""
    import multiprocessing
    import random
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import extract_features_for_video
    from tim_tpu_torch.utils.pdpickle import read_pickle

    times = os.path.join(JPEG_DIR, "feature_times.pkl")
    table = read_pickle(times)
    built, banks, clean = state["built"], state["banks"], state["clean"]
    files = jpeg_fixture.frame_paths()
    real = ecli.make_visual_apply
    ecli.make_visual_apply = lambda args, device=None: built[args.backbone]
    spawn = multiprocessing.get_context("spawn")
    argvs, workers = {}, {}
    paths, numbers, sets = {}, {}, {}
    try:
        # the twins' augmentation and transforms (host only: numpy and the
        # host library) in one worker a backbone, beside the CLIs' runs
        t0 = time.perf_counter()
        for name, (num_frames, _) in JPEG_BACKBONES.items():
            argvs[name] = [
                "--backbone", name, "--frames_dir",
                os.path.join(JPEG_DIR, "frames"), "--feature_times", times,
                "--split", "val", "--num_frames", str(num_frames),
                "--batch_size", str(JPEG_BATCH), "--num_aug", "2",
                "--out_dir", str(tmp / name)]
            twin_dir = tmp / f"{name}_twins"
            twin_dir.mkdir()
            # the decodes go by file: a spawned worker reads its arguments
            # only after its imports, and start() waits for a large pickle
            for vid, ps in files.items():
                np.save(twin_dir / f"{vid}.npy",
                        np.stack([state["decoded"][p][0] for p in ps]))
            workers[name] = spawn.Process(target=autoaug_twin_clips, args=(
                name, num_frames, argvs[name], str(twin_dir)))
            workers[name].start()
        numbers["workers_start_s"] = time.perf_counter() - t0
        for name, (num_frames, kernel) in JPEG_BACKBONES.items():
            random.seed(AUTOAUG_SEED)
            np.random.seed(AUTOAUG_SEED)
            counters = zero_counts()
            t0 = time.perf_counter()
            ecli.main(argvs[name], device="cuda")
            launches = read_counts(counters)
            wall = time.perf_counter() - t0
            worker, twin_dir = workers[name], tmp / f"{name}_twins"
            worker.join(timeout=300)
            twin_wait = time.perf_counter() - t0 - wall
            require(worker.exitcode == 0,
                    f"autoaug-extract-{name}: the twins' worker exited "
                    f"{worker.exitcode}")
            clips = forwards = 0
            t0 = time.perf_counter()
            for vid in sorted(files):
                rows = len(table.where(table["video_id"] == vid))

                def clip_fn(t, a, vid=vid):
                    if a == 0:
                        return clean[(name, vid, t)]
                    return np.load(twin_dir / f"{vid}_{t}.npy")

                want = extract_features_for_video(
                    clip_fn, rows, 2, built[name], batch_size=JPEG_BATCH)
                got = np.load(tmp / name / "val" / f"{vid}.npy")
                require(got.shape == (rows, 2, 1024)
                        and bool(np.isfinite(got).all()),
                        f"autoaug-extract-{name}: {vid} bank {got.shape} or "
                        f"non-finite")
                require(same(got[:, :1], banks[(name, vid)]),
                        f"autoaug-extract-{name}: {vid}: set 0 differs from "
                        f"phase 29's bank")
                require(same(got[:, 1], want[:, 1]),
                        f"autoaug-extract-{name}: {vid}: set 1 differs from "
                        f"the numpy twins' RandAugment route")
                require(not same(got[:, 1], got[:, 0]),
                        f"autoaug-extract-{name}: {vid}: set 1 equals set 0")
                sets[(name, vid)] = got
                clips += rows
                forwards += -(-2 * rows // JPEG_BATCH)
            twin_s = time.perf_counter() - t0
            require(launches[kernel] == 24 * forwards
                    and attention_launches(launches) == launches[kernel],
                    f"autoaug-extract-{name}: launches {launches}, expected "
                    f"24 x {forwards} of {kernel}")
            paths[f"autoaug-extract-{name}"] = launches
            numbers[name] = {"clips": clips, "sets": 2, "forwards": forwards,
                             "wall_s": wall,
                             "wall_clips_per_s": 2 * clips / wall,
                             "twins_wait_s": twin_wait,
                             "twins_forwards_s": twin_s}
            log(f"[autoaug-extract-{name}] extract.cli.main --num_aug 2 over "
                f"{len(files)} EPIC frame directories, {clips} clips x 2 "
                f"sets of {num_frames} frames, bf16, batch {JPEG_BATCH}: "
                f"{wall:.3f} s ({2 * clips / wall:.2f} wall clips/s); set 0 "
                f"bit-equal to phase 29's banks, set 1 to the numpy twins' "
                f"route (waited {twin_wait:.3f} s for its worker after the "
                f"CLI, its forwards {twin_s:.3f} s); launches {launches} "
                f"({forwards} forwards, {launches[kernel] / forwards:.0f} of "
                f"{kernel} each)")
    finally:
        ecli.make_visual_apply = real
        for worker in workers.values():
            if worker.is_alive():
                worker.kill()
            worker.join()
    return paths, numbers, sets


def autoaug_clip(jpeg_fixture, decoded):
    """30c: one ``EK100ClipDataset(mode="train")`` item, frames through
    ``jpeg_frame_reader`` and the default ``VideoRandAugment``, bit-equal
    to the same item over the twin-checked (oriented) decodes with the
    numpy twins, under the same seeds."""
    import random
    from tim_tpu_torch.extract.clips import EK100ClipDataset, jpeg_frame_reader
    from tim_tpu_torch.extract.autoaug import VideoRandAugment
    files = jpeg_fixture.frame_paths()

    def twins(video_id, indices, offset):
        return np.stack([decoded[files[video_id][int(i) + offset]][1]
                         for i in indices])

    kw = dict(annotations={"video_id": np.asarray(["P01_01"]),
                           "start_frame": np.asarray([0]),
                           "stop_frame": np.asarray([12]),
                           "verb_class": np.asarray([3]),
                           "noun_class": np.asarray([7])},
              mode="train", num_frames=16, crop_size=224)
    port = EK100ClipDataset(frame_reader=jpeg_frame_reader(
        os.path.join(JPEG_DIR, "frames"), "frame_{:010d}.jpg"), **kw)
    require(isinstance(port.rand_augment, VideoRandAugment),
            f"autoaug-clip: the default RandAugment is "
            f"{type(port.rand_augment)}")
    random.seed(AUTOAUG_SEED)
    np.random.seed(AUTOAUG_SEED)
    t0 = time.perf_counter()
    got = port[0]
    port_s = time.perf_counter() - t0
    with PlainTwins():
        ref = EK100ClipDataset(frame_reader=twins, **kw)
        random.seed(AUTOAUG_SEED)
        np.random.seed(AUTOAUG_SEED)
        want = ref[0]
    require(sorted(got) == sorted(want)
            and all(same(got[k], want[k]) for k in want),
            "autoaug-clip: the training item differs from the twins' route")
    log(f"[autoaug-clip] EK100ClipDataset(train, 16 x 224^2, num_sample 2) "
        f"with VideoRandAugment: item {got['video'].shape} bit-equal to the "
        f"numpy twins' route ({port_s:.3f} s)")
    return {"item_s": port_s, "shape": list(got["video"].shape)}


def autoaug_control(fx, decoded, sets):
    """30d: a fixture output and a set-1 bank with one byte changed are
    refused by the comparisons above."""
    from tim_tpu_torch.extract import autoaug
    case = next(c for c in fx.cases()
                if c["key"] == "epic1/Rotate/m7s0.5/bicubic/imagenet")
    frames = fx.frames(lambda p: decoded[p][0])
    out = np.array(fx.run_case(autoaug, frames[case["frame"]], case))
    want = fx.read_digests()["digests"][case["key"]]
    require(fx.digest(out) == want, "autoaug-control: the case itself fails")
    out.reshape(-1)[out.size // 2] ^= 1
    require(fx.digest(out) != want,
            "autoaug-control: a changed byte passed the digest check")
    bank = sets[("videomae", "P01_01")]
    flipped = bank.copy()
    flipped.view(np.uint8).reshape(-1)[flipped.nbytes // 3] ^= 1
    require(same(bank, bank.copy()) and not same(flipped, bank),
            "autoaug-control: a changed bank byte passed the comparison")
    log(f"[autoaug-control] one byte changed: {case['key']}'s output "
        f"refused by its digest, a set-1 bank refused by the comparison")
    return {"case": case["key"], "refused": True}


AUTOAUG_COMPARE = r'''
import importlib.util, json, os, sys, time
import numpy as np
import PIL
from PIL import Image, ImageEnhance, ImageFilter, ImageOps
from tim_tpu_torch.extract import imageops as O

root, jpeg_root, rate_ops = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(root, "make_fixture.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)


def solarize_add(im, add):
    return im.point([min(255, i + add) if i < 128 else i
                     for i in range(256)] * 3)


PIL_OPS = {
    "autocontrast": ImageOps.autocontrast, "equalize": ImageOps.equalize,
    "invert": ImageOps.invert, "posterize": ImageOps.posterize,
    "solarize": ImageOps.solarize, "solarize_add": solarize_add,
    "color": lambda im, f: ImageEnhance.Color(im).enhance(f),
    "contrast": lambda im, f: ImageEnhance.Contrast(im).enhance(f),
    "brightness": lambda im, f: ImageEnhance.Brightness(im).enhance(f),
    "sharpness": lambda im, f: ImageEnhance.Sharpness(im).enhance(f),
    "smooth": lambda im: im.filter(ImageFilter.SMOOTH),
    "rotate": lambda im, a, rs, fill: im.rotate(a, resample=rs,
                                                fillcolor=tuple(fill)),
    "affine": lambda im, m, rs, fill: im.transform(
        im.size, Image.AFFINE, tuple(m), resample=rs, fillcolor=tuple(fill)),
}


def grid(w, h):
    fills = ([128, 128, 128], [124, 116, 104])
    out = [("autocontrast", []), ("equalize", []), ("invert", []),
           ("smooth", [])]
    out += [("posterize", [b]) for b in range(9)]
    out += [("solarize", [t]) for t in (0, 64, 128, 192, 256)]
    out += [("solarize_add", [a]) for a in (0, 27, 55, 110)]
    out += [(e, [f]) for e in ("color", "contrast", "brightness", "sharpness")
            for f in (0.0, 0.1, 0.55, 1.0, 1.45, 1.9, -0.5, 2.5)]
    for rs in (0, 2, 3):
        for fill in fills:
            out += [("rotate", [a, rs, fill])
                    for a in (0.0, 7.5, -7.5, 15.0, -30.0, 90.0, 180.0)]
            out += [("affine", [m, rs, fill]) for m in (
                [1, 0.3, 0, 0, 1, 0], [1, -0.15, 0, 0, 1, 0],
                [1, 0, 0, 0.3, 1, 0], [1, 0, 0, -0.15, 1, 0],
                [1, 0, 0.225 * w, 0, 1, 0], [1, 0, 0, 0, 1, -0.45 * h],
                [1, 0, -100, 0, 1, 0], [1, 0, 0, 0, 1, 100])]
    return out


def random_grid(rng, n):
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(1, 65, 2))
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        fill = [int(v) for v in rng.integers(0, 256, 3)]
        rs = int(rng.choice([0, 2, 3]))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            case = ("rotate", [float(rng.uniform(-180, 180)), rs, fill])
        elif kind == 1:
            s = float(rng.uniform(-1, 1))
            case = ("affine", [[1, s, 0, 0, 1, 0] if rng.random() < 0.5
                               else [1, 0, 0, s, 1, 0], rs, fill])
        elif kind == 2:
            case = ("affine", [[1, 0, float(rng.uniform(-w, w)), 0, 1,
                                float(rng.uniform(-h, h))], rs, fill])
        elif kind == 3:
            case = ("affine", [[float(v) for v in rng.uniform(-2, 2, 6)], rs,
                               fill])
        else:
            case = (str(rng.choice(["color", "contrast", "brightness",
                                    "sharpness"])),
                    [float(rng.uniform(-1, 3))])
        out.append((frame, case))
    return out


def differs(frame, name, args):
    want = np.asarray(PIL_OPS[name](Image.fromarray(frame), *args))
    got = getattr(O, name)(frame, *args)
    return -1 if got.shape != want.shape else int((got != want).sum())


def pil_read(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


frames = fx.frames(pil_read)
out = {"PIL": PIL.__version__, "grid": {"cases": 0, "mismatched": []},
       "random": {"cases": 0, "mismatched": []}}
for frame_name in ("epic0", "odd_17x9", "odd_1x33"):
    frame = frames[frame_name]
    for name, args in grid(frame.shape[1], frame.shape[0]):
        n = differs(frame, name, args)
        out["grid"]["cases"] += 1
        if n:
            out["grid"]["mismatched"].append([frame_name, name, args, n])
for frame, (name, args) in random_grid(np.random.default_rng(30), 400):
    n = differs(frame, name, args)
    out["random"]["cases"] += 1
    if n:
        out["random"]["mismatched"].append([list(frame.shape), name, args, n])
# frames/s: Pillow one frame at a time (images made beforehand), the port
# one call over the clip
epic = np.stack([pil_read(p) for p in fx.epic_paths()])
images = [Image.fromarray(f) for f in epic]
rates = {}
for cls, name, args in rate_ops:
    t0 = time.perf_counter()
    for im in images:
        PIL_OPS[name](im, *args)
    pil_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    getattr(O, name)(epic, *args)
    port_s = time.perf_counter() - t0
    n, p, q = rates.get(cls, (0, 0.0, 0.0))
    rates[cls] = (n + len(epic), p + pil_s, q + port_s)
out["frames_per_s"] = {cls: {"pil": n / p, "port": n / q}
                       for cls, (n, p, q) in rates.items()}
print(json.dumps(out))
'''


def autoaug_compare():
    """30e, where the card's machine has PIL: in a subprocess (so that
    this process never loads it), Pillow's ops against the port's over the
    fixture's grid (an EPIC frame and the two odd ones: every op, bits,
    thresholds, factors, angles, shears, translations, resamples and
    fills) and a seeded random grid of sizes, angles, shears, matrices and
    factors; any mismatch fails; Pillow's and the port's frames/s of each
    op class side by side."""
    import importlib.util
    if importlib.util.find_spec("PIL") is None:
        log("[autoaug-compare] skipped: the machine has no PIL")
        return {"skipped": True}
    run = subprocess.run(
        [sys.executable, "-c", AUTOAUG_COMPARE, AUTOAUG_DIR, JPEG_DIR,
         json.dumps(AUTOAUG_RATE_OPS)], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    require(run.returncode == 0,
            f"autoaug-compare failed:\n{run.stderr[-3000:]}")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    g, r = out["grid"], out["random"]
    log(f"[autoaug-compare] PIL {out['PIL']}: fixture grid {g['cases']} "
        f"cases, {len(g['mismatched'])} differ {g['mismatched'][:5]}; random "
        f"grid {r['cases']} cases, {len(r['mismatched'])} differ "
        f"{r['mismatched'][:5]}; EPIC frames/s, Pillow one frame at a time "
        f"vs the port one call a clip: " + ", ".join(
            f"{cls} {v['pil']:.1f} vs {v['port']:.1f}"
            for cls, v in out["frames_per_s"].items()))
    require(not g["mismatched"] and not r["mismatched"],
            f"autoaug-compare: the port differs from Pillow: "
            f"{g['mismatched'][:10]} {r['mismatched'][:10]}")
    return out


def phase_autoaug(card: str, state):
    """Phase 30 on phase 29's fixture module, decodes and backbones;
    returns the launches by path."""
    import pathlib
    import tempfile
    t0 = time.perf_counter()
    blocked = ("PIL", "cv2")
    saved = block_modules(blocked)
    fx, jpeg_fixture = autoaug_fixture(), state["fixture"]
    parts, mark = {}, time.perf_counter()

    def lap(part):
        nonlocal mark
        now = time.perf_counter()
        parts[part], mark = now - mark, now

    try:
        summary = {"card": card, "part_seconds": parts,
                   "ops": autoaug_ops(fx, jpeg_fixture, state["decoded"])}
        lap("a")
        with tempfile.TemporaryDirectory() as tmp:
            paths, summary["extract"], sets = autoaug_extract(
                jpeg_fixture, state, pathlib.Path(tmp))
        lap("b")
        summary["clip"] = autoaug_clip(jpeg_fixture, state["decoded"])
        summary["control"] = autoaug_control(fx, state["decoded"], sets)
        lap("c_d")
    finally:
        unblock_modules(saved)
        state["built"].clear()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in blocked and sys.modules[m])
    require(not loaded, f"autoaug: PIL or cv2 was imported: {loaded}")
    summary["seconds_a_to_d"] = time.perf_counter() - t0
    summary["compare"] = autoaug_compare()
    lap("e")
    summary["seconds"] = time.perf_counter() - t0
    log(f"[autoaug] summary {json.dumps(summary)}; PIL and cv2 blocked in "
        f"a-d; {summary['seconds']:.2f} s (limit {AUTOAUG_LIMIT_S:.0f} s)")
    require(summary["seconds"] <= AUTOAUG_LIMIT_S,
            f"autoaug: {summary['seconds']:.2f} s, past its limit")
    return paths


# ---------------------------------------------------------------------------
# Phase 21: raw media. scripts/bench_serve_frames.py's geometry: 50 fps
# 224^2 uint8 frames, a 1.1 s clip every 0.2 s (Swin-B 32 frames, ViT-L 16,
# one origin), spectrograms [400, 128], 30 s windows at stride 1 s.
# ---------------------------------------------------------------------------
MEDIA_FPS, MEDIA_HOP, MEDIA_INTERVAL = 50.0, 0.2, 1.1
MEDIA_SECONDS, MEDIA_LONG_SECONDS = 40.0, 80.0
MEDIA_RES = 224
MEDIA_SPEC = (400, 128)
MEDIA_BATCH = 16         # the bench script's detection batch
MEDIA_TOP = 50           # the best detections whose labels are compared
# Random weights give scores whose spread no fixed threshold fits: each
# raw-media server thresholds at the score about this many top-8
# candidates a window clear, read off a first call with no candidates
MEDIA_CANDIDATES = 100
MEDIA_MODES = ("naive", "stream", "gather", "pair_embed")
# int8 vs fp32 contracts of tests/test_backbone_quant.py, held here
# against bf16 (the int8 backbones compute in bf16)
INT8_DYNAMIC_REL, INT8_STATIC_REL = 0.08, 0.12
# the fp32 card-vs-CPU call: 2 timesteps (one 30 s window), backbones cut
# in depth, the detector at full width
MEDIA_FP32_STEPS = 2
# the busy share is read off a profiled call over the first 40 timesteps
# (8 s of video), which keeps the trace's post-processing short
MEDIA_PROFILE_STEPS = 40
SWIN_CUT, VIT_CUT, SLOWFAST_CUT = (2, 1, 1, 1), 2, (1, 1, 1, 1)


def media_clip_table(n_steps, n_samples):
    """``scripts/bench_media_ingest.py::clip_table(rebase=False)``:
    ``omnivore_frame_indices`` rows at the 0.2 s hop, 0-based."""
    from tim_tpu_torch.extract.pipeline import omnivore_frame_indices
    span = int(round(MEDIA_INTERVAL * MEDIA_FPS))
    rows = [omnivore_frame_indices(
        span, int(round(t * MEDIA_HOP * MEDIA_FPS)) + 1, 10 ** 9,
        num_samples=n_samples) for t in range(n_steps)]
    return np.stack(rows) - 1


def media_tables(n_steps):
    """[Swin table (32 frames), ViT table (16)] from one origin."""
    ts, tv = media_clip_table(n_steps, 32), media_clip_table(n_steps, 16)
    origin = int(min(ts.min(), tv.min()))
    return [ts - origin, tv - origin]


def media_inputs(n_steps, frames, specs):
    """(frames, the two clip tables, feature times, spectrograms) of the
    first ``n_steps`` timesteps."""
    tables = media_tables(n_steps)
    n_frames = max(int(t.max()) for t in tables) + 1
    starts = (np.arange(n_steps) * MEDIA_HOP).astype(np.float32)
    feat_times = np.stack([starts, starts + MEDIA_INTERVAL], -1)
    return frames[:n_frames], tables, feat_times, specs[:n_steps]


def media_backbones(dtype, device, **cut):
    """Swin-B and ViT-L (generator seeded SEED, as ``make_visual_apply``
    builds them), ``cut`` in depth if given."""
    from tim_tpu_torch.models.backbones import swin3d, vit
    gen = torch.Generator
    swin = swin3d.omnivore_swinB_epic(
        dtype=dtype, device=device, generator=gen().manual_seed(SEED),
        **({"depths": cut["swin"]} if cut else {}))
    vitm = vit.videomae_vit_large(
        dtype=dtype, device=device, generator=gen().manual_seed(SEED),
        **({"depth": cut["vit"]} if cut else {}))
    return [swin.eval(), vitm.eval()]


class MediaSpy:
    """Records what ``detect_video_frames`` computes on its way: each
    backbone's features (``dense_media.extract_dense_visual``), the audio
    features (``server._extract``), and, with ``stages``, each stage's
    wall seconds (the features end in a read-back; the detection batches
    by CUDA events; Soft-NMS by the host clock)."""

    def __init__(self, server, stages: bool = False):
        import tim_tpu_torch.serve as serve_mod
        from tim_tpu_torch.extract import dense_media
        self.server, self.stages = server, stages
        self.visual, self.audio, self.secs = [], None, {}
        self.infer_events = []
        self._dm, self._serve = dense_media, serve_mod
        self._orig = (dense_media.extract_dense_visual, server._extract,
                      server._infer, serve_mod.nms_per_video)

    def __enter__(self):
        dm_extract, s_extract, s_infer, nms = self._orig

        def extract(model, *args, **kwargs):
            t0 = time.perf_counter()
            out = dm_extract(model, *args, **kwargs)
            self.add("swin" if hasattr(model, "layers") else "vit", t0)
            self.visual.append(out)
            return out

        def audio(*args, **kwargs):
            t0 = time.perf_counter()
            self.audio = s_extract(*args, **kwargs)
            self.add("slowfast", t0)
            return self.audio

        def infer(batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = s_infer(batch)
            end.record()
            self.infer_events.append((start, end))
            return out

        def nms_per_video(*args, **kwargs):
            t0 = time.perf_counter()
            out = nms(*args, **kwargs)
            self.add("nms", t0)
            return out

        self._dm.extract_dense_visual = extract
        self.server._extract = audio
        self.server._infer = infer
        self._serve.nms_per_video = nms_per_video
        return self

    def add(self, stage, t0):
        if self.stages:
            torch.cuda.synchronize()
        self.secs[stage] = self.secs.get(stage, 0.0) + time.perf_counter() - t0

    def __exit__(self, *exc):
        self._dm.extract_dense_visual = self._orig[0]
        self._serve.nms_per_video = self._orig[3]
        del self.server._extract            # the class's method again
        self.server._infer = self._orig[2]
        return False

    def detection_s(self):
        return sum(s.elapsed_time(e) for s, e in self.infer_events) / 1e3


def media_call(server, models, video, mode, threshold, *,
               count_launches=False, extract_batch=8):
    """One ``detect_video_frames`` call (uint8 frames, the device
    normalizer); returns (detections, wall seconds, launches or None)."""
    from tim_tpu_torch.extract.dense_media import uint8_normalizer
    frames, tables, feat_times, specs = video
    duration = len(feat_times) * MEDIA_HOP
    counts = zero_counts() if count_launches else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = server.detect_video_frames(
        frames, tables, feat_times, duration, visual_model=models,
        audio_specs=specs, audio_extractor=server.media_audio,
        extract_batch=extract_batch, mode=mode,
        frame_transform=uint8_normalizer(
            dtype=str(models[0].dtype).split(".")[-1]),
        score_threshold=threshold)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dets, wall, (read_counts(counts) if count_launches else None)


def media_threshold(server, models, video):
    """A first ``detect_video_frames`` call (threshold 1: no candidates)
    whose top-8 scores of proposals of positive length set the threshold
    that MEDIA_CANDIDATES a window clear; it also warms the path up."""
    import tim_tpu_torch.serve as serve_mod
    seen = []
    orig = serve_mod.threshold_predictions_topk

    def spy(vids, props, vals, classes, **kwargs):
        props = np.round(np.asarray(props, np.float64), 3)
        seen.append(vals[props[:, 1] > props[:, 0]])   # the rows kept
        return orig(vids, props, vals, classes, **kwargs)
    serve_mod.threshold_predictions_topk = spy
    try:
        media_call(server, models, video, "stream", 1.0)
    finally:
        serve_mod.threshold_predictions_topk = orig
    vals = np.sort(np.concatenate([v.ravel() for v in seen]))[::-1]
    windows = len(server._window_starts(len(video[2]) * MEDIA_HOP))
    return float(vals[min(len(vals) - 1, MEDIA_CANDIDATES * windows)])


def require_media_dets(tag, dets):
    segs, scores = dets["segments"], dets["scores"]
    require(len(scores) > 0, f"{tag}: no detections")
    require(bool(np.isfinite(segs).all() and np.isfinite(scores).all()),
            f"{tag}: non-finite detections")
    require(bool((segs[:, 1] > segs[:, 0]).all()), f"{tag}: empty segments")
    require(bool((np.diff(scores) <= 1e-6).all()),
            f"{tag}: detections not score-sorted")


def compare_media_dets(tag, got, want):
    """The best MEDIA_TOP detections of two runs: scores within the bf16
    score gate; their labels equal as multisets over the leading k whose
    k-th and (k+1)-th reference scores are farther apart than the scores'
    largest difference (an order within that difference is undecided)."""
    n = min(MEDIA_TOP, len(got["scores"]), len(want["scores"]))
    require(n > 0, f"{tag}: no detections to compare")
    d = float(np.abs(got["scores"][:n] - want["scores"][:n]).max())
    ws = want["scores"]
    k = n
    while k > 0 and k < len(ws) and ws[k - 1] - ws[k] <= d:
        k -= 1
    same = sorted(got["labels"][:k].tolist()) == sorted(
        want["labels"][:k].tolist())
    log(f"[{tag}] vs naive: top-{n} scores max diff {d:.3e} (tol "
        f"{BF16_SCORE_TOL}); labels of the top {k} equal: {same}")
    require(d <= BF16_SCORE_TOL, f"{tag}: scores drift {d}")
    require(same, f"{tag}: labels of the top {k} differ")
    return {"score_diff": d, "labels_compared": k}


def media_launches_expected(tag, launches, n_steps, n_batches, kernels):
    """Kernels 4 and 5: 24 a forward of 8 clips; 1 and 2: 6 a detection
    batch (where ``kernels`` names them)."""
    forwards = -(-n_steps // 8)
    want = {"window_attention": 24 * forwards, "flash_mha": 24 * forwards,
            "query_block_attention": 6 * n_batches,
            "fused_post_attention": 6 * n_batches}
    for name in kernels:
        require(launches[name] == want[name], f"{tag}: {name} launched "
                f"{launches[name]} times, expected {want[name]}")


def phase_int8_backbones(clips_by_name, bf16_models):
    """21a: ``make_visual_apply(--quantize_backbone on)`` for Swin-B and
    ViT-L in bf16: features against the bf16 backbone's (dynamic and a
    calibrated static twin), timed extraction of EXTRACT_CLIPS clips each
    way, and an fp32 int8 forward of one clip at reduced depth, card
    against CPU."""
    from tim_tpu_torch.extract.cli import build_parser, make_visual_apply
    from tim_tpu_torch.ops import quant
    paths, summary, int8_models = {}, {}, []
    bf16 = dict(zip(BACKBONES, bf16_models))
    for name, clips in clips_by_name.items():
        args = build_parser().parse_args(
            ["--backbone", name, "--feature_times", "-", "--out_dir", "-",
             "--compute_dtype", "bfloat16", "--quantize_backbone", "on",
             "--num_frames", str(BACKBONES[name][1][0])])
        t0 = time.perf_counter()
        apply_q = make_visual_apply(args)
        build_s = time.perf_counter() - t0
        model = apply_q.model
        x = torch.from_numpy(clips).cuda()
        want = bf16[name](x).float()
        dyn = apply_q(x)
        rel = (max_err(dyn, want) / want.abs().max()).item()
        launches, m_dyn = time_extraction(f"extract-{name}-int8", name,
                                          apply_q)
        scales = quant.calibrate_act_scales(model.int8_layers(), model, [x])
        model.set_act_scales(scales)
        static = apply_q(x)
        rel_s = (max_err(static, want) / want.abs().max()).item()
        _, m_static = time_extraction(f"extract-{name}-int8-static", name,
                                      apply_q)
        model.set_act_scales(())
        int8_models.append(model)
        log(f"[int8-{name}] quantized from fp32 in {build_s:.2f} s, "
            f"{len(scales)} int8 layers; vs bf16 features (2 clips): "
            f"dynamic {rel:.4e} (tol {INT8_DYNAMIC_REL}), calibrated static "
            f"{rel_s:.4e} (tol {INT8_STATIC_REL})")
        require(rel <= INT8_DYNAMIC_REL, f"{name} int8 dynamic drift {rel}")
        require(rel_s <= INT8_STATIC_REL, f"{name} int8 static drift {rel_s}")
        err, lim = int8_backbone_card_vs_cpu(name, clips[:1])
        paths[f"extract-{name}-int8"] = launches
        summary[name] = {"dynamic_rel": rel, "static_rel": rel_s,
                         "fp32_card_vs_cpu": err, "fp32_limit": lim,
                         "dynamic": m_dyn, "static": m_static,
                         "build_s": build_s}
        del apply_q, model
    torch.cuda.empty_cache()
    return paths, summary, int8_models


def int8_backbone_card_vs_cpu(name, clip):
    """The int8 backbone in fp32 at reduced depth (Swin-B SWIN_CUT, ViT-L
    VIT_CUT blocks) on one clip, card against CPU: within SLICE_TOL of the
    largest feature, or ULP_ENVELOPE times the CPU's own spread under a
    one-ulp input change where that is larger (int8 codes sitting on a
    rounding tie flip with the fp32 sums' order, as in phase 6)."""
    from tim_tpu_torch.ops.quant import quantize_backbone_state_dict
    cut = {"swin": SWIN_CUT, "vit": VIT_CUT}
    fp = media_backbones("float32", "cpu", **cut)[list(BACKBONES).index(name)]
    factory = type(fp)
    kw = {"depths": SWIN_CUT} if name == "omnivore" else {"depth": VIT_CUT}
    state = quantize_backbone_state_dict(fp.state_dict())
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = factory(**kw, device=dev, quantized=True)
        models[dev].load_state_dict(state, strict=True)
    x = torch.from_numpy(clip)
    counts = zero_counts()
    gpu = models["cuda"](x.cuda()).float().cpu()
    launches = read_counts(counts)
    t0 = time.perf_counter()
    cpu = models["cpu"](x)
    cpu_s = time.perf_counter() - t0
    cpu_up = models["cpu"](x * (1 + 2.0 ** -23))
    scale = cpu.abs().max().item()
    err = max_err(gpu, cpu) / scale
    spread = max_err(cpu_up, cpu) / scale
    lim = max(SLICE_TOL, ULP_ENVELOPE * spread)
    kernel = BACKBONES[name][2]
    blocks = sum(SWIN_CUT) if name == "omnivore" else VIT_CUT
    log(f"[int8-{name}-fp32] {blocks} blocks, one clip: card vs CPU "
        f"{err:.3e} of the largest feature (limit {lim:.3e}: the CPU's "
        f"one-ulp spread {spread:.3e}); CPU {cpu_s:.2f} s; launches "
        f"{launches}")
    require(launches[kernel] == blocks, f"int8 {name} fp32: {kernel} "
            f"launched {launches[kernel]} times, expected {blocks}")
    require(err <= lim, f"int8 {name} fp32 card vs CPU {err} > {lim}")
    return err, lim


def media_server(cfg, state_dict, device, audio, batch_size=MEDIA_BATCH,
                 **kwargs):
    from tim_tpu_torch.serve import DetectionServer
    server = DetectionServer(cfg, state_dict, device=device,
                             batch_size=batch_size, **kwargs)
    server.media_audio = audio
    return server


def audio_apply(device, **kw):
    """Auditory SlowFast (generator seeded SEED) as the extraction CLI
    applies it: spectrograms [B, T, F, 1] -> fp32 features [B, 2304]."""
    from tim_tpu_torch.extract.cli import AudioApply
    from tim_tpu_torch.models.backbones.slowfast import AuditorySlowFast
    model = AuditorySlowFast(device=device, **kw,
                             generator=torch.Generator().manual_seed(SEED))
    return AudioApply(model.eval(), torch.device(device))


def phase_media_serving(models, state_dict, frames, specs):
    """21b: ``detect_video_frames`` with [Swin-B, ViT-L] and SlowFast on
    ``epic_detection`` in bf16 (kernel 2 fused, top-8, batch 16) over the
    40 s video in every mode, each against ``detect_video`` over the naive
    path's features; the stream run's launches; a stage breakdown; the
    device's busy share; the bench's own ``fast_scores`` server; the 80 s
    video in stream mode."""
    from torch.profiler import ProfilerActivity, profile
    from tim_tpu_torch import config as C
    n_steps = int(round(MEDIA_SECONDS / MEDIA_HOP))
    video = media_inputs(n_steps, frames, specs)
    audio = audio_apply("cuda")
    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True)
    server = media_server(cfg, state_dict, "cuda", audio, top_k=8)
    n_batches = -(-len(server._window_starts(MEDIA_SECONDS)) // MEDIA_BATCH)
    threshold = media_threshold(server, models, video)
    log(f"[media] {MEDIA_SECONDS:.0f} s video: {n_steps} timesteps, "
        f"{len(video[0])} unique uint8 frames ({video[0].nbytes / 1e6:.1f} "
        f"MB), {n_batches} detection batch(es) of {MEDIA_BATCH}; score "
        f"threshold {threshold:.6f} ({MEDIA_CANDIDATES} top-8 candidates a "
        f"window)")
    out, summary = {}, {"modes": {}, "threshold": threshold}
    for mode in MEDIA_MODES:
        with MediaSpy(server) as spy:
            dets, wall, launches = media_call(
                server, models, video, mode, threshold,
                count_launches=mode == "stream")
        require_media_dets(f"media-{mode}", dets)
        out[mode] = (dets, spy.visual, spy.audio)
        summary["modes"][mode] = {"wall_s": wall,
                                  "real_time": MEDIA_SECONDS / wall,
                                  "detections": len(dets["scores"])}
        log(f"[media-{mode}] {wall:.3f} s wall: "
            f"{MEDIA_SECONDS / wall:.3f}x real time, "
            f"{len(dets['scores'])} detections")
        if mode == "stream":
            media_launches_expected("media-frames-bf16", launches, n_steps,
                                    n_batches, ("window_attention",
                                                "flash_mha",
                                                "query_block_attention",
                                                "fused_post_attention"))
            log(f"[media-stream] launches {launches}")
            bf16_launches = launches
    _, naive_visual, naive_audio = out["naive"]
    ref = server.detect_video(
        np.concatenate([f.float().numpy() for f in naive_visual], -1),
        naive_audio, video[2], MEDIA_SECONDS, score_threshold=threshold)
    require_media_dets("media-reference", ref)
    for mode in MEDIA_MODES:
        dets, visual, _ = out[mode]
        rel = max((max_err(g.float(), w.float()) / w.float().abs().max()
                   ).item() for g, w in zip(visual, naive_visual))
        log(f"[media-{mode}] features vs naive: {rel:.4e} of the largest "
            f"(tol {BF16_FEATURE_TOL})")
        require(rel <= BF16_FEATURE_TOL, f"media {mode} features {rel}")
        summary["modes"][mode].update(feature_rel=rel,
                                      **compare_media_dets(
                                          f"media-{mode}", dets, ref))

    # stages, one stream call with a synchronize after each
    bank = torch.from_numpy(video[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank.pin_memory().cuda()
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    with MediaSpy(server, stages=True) as spy:
        _, wall, _ = media_call(server, models, video, "stream", threshold)
    stages = {"upload (whole bank, pinned, alone)": upload, **spy.secs,
              "detection (device)": spy.detection_s(), "wall": wall}
    log(f"[media-stages] seconds: {json.dumps(stages)}")
    summary["stages_s"] = stages
    # the device's busy share over one stream call
    short = media_inputs(MEDIA_PROFILE_STEPS, frames, specs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = media_call(server, models, short, "stream", threshold)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e6
    log(f"[media-busy] profiled stream call over {MEDIA_PROFILE_STEPS} "
        f"timesteps: {wall:.3f} s wall, kernels {busy:.3f} s: "
        f"{100 * busy / wall:.1f}% busy")
    summary["busy_share"] = busy / wall

    # the bench script's own server: bf16 scores, dense dump, batch 16
    fast = media_server(C.epic_detection(compute_dtype="bfloat16",
                                         fast_scores=True),
                        state_dict, "cuda", audio)
    media_call(fast, models, media_inputs(20, frames, specs), "stream",
               1.0)                                         # warm-up
    dets, wall, fast_launches = media_call(fast, models, video, "stream",
                                           threshold, count_launches=True)
    require_media_dets("media-frames-fast", dets)
    media_launches_expected("media-frames-fast", fast_launches, n_steps,
                            n_batches, ("window_attention", "flash_mha"))
    require(fast_launches["query_block_attention"] == 0
            and fast_launches["fused_post_attention"] == 0,
            f"media-frames-fast: {fast_launches}")
    summary["fast_scores"] = {"wall_s": wall,
                              "real_time": MEDIA_SECONDS / wall,
                              "detections": len(dets["scores"])}
    log(f"[media-frames-fast] {wall:.3f} s: {MEDIA_SECONDS / wall:.3f}x "
        f"real time; launches {fast_launches}")
    del fast

    long = media_inputs(int(round(MEDIA_LONG_SECONDS / MEDIA_HOP)), frames,
                        specs)
    dets, wall, _ = media_call(server, models, long, "stream", threshold)
    require_media_dets("media-80s", dets)
    summary["stream_80s"] = {"wall_s": wall,
                             "real_time": MEDIA_LONG_SECONDS / wall,
                             "detections": len(dets["scores"]),
                             "frames": len(long[0])}
    log(f"[media-80s] {MEDIA_LONG_SECONDS:.0f} s video, {len(long[0])} "
        f"frames: {wall:.3f} s, {MEDIA_LONG_SECONDS / wall:.3f}x real time")
    del server
    torch.cuda.empty_cache()
    return {"media-frames-bf16": bf16_launches,
            "media-frames-fast": fast_launches}, summary


def phase_media_fp32(state_dict, frames, specs):
    """21c: one short fp32 ``detect_video_frames`` (MEDIA_FP32_STEPS
    timesteps, one window) with Swin-B and ViT-L cut in depth, SlowFast
    cut to one block a stage and the detector at full width, card against
    CPU: labels equal, segments and scores within SLICE_TOL."""
    from tim_tpu_torch import config as C
    video = media_inputs(MEDIA_FP32_STEPS, frames, specs)
    cfg = C.epic_detection(compute_dtype="float32")
    dets, secs = {}, {}
    cut = {"swin": SWIN_CUT, "vit": VIT_CUT}
    threshold = None
    for dev in ("cuda", "cpu"):
        server = media_server(cfg, state_dict, dev,
                              audio_apply(dev, depths=SLOWFAST_CUT),
                              batch_size=1, top_k=8)
        models = media_backbones("float32", dev, **cut)
        if threshold is None:
            threshold = media_threshold(server, models, video)
        t0 = time.perf_counter()
        # one extraction batch of the timesteps (no padded clips)
        dets[dev], _, _ = media_call(server, models, video, "stream",
                                     threshold,
                                     extract_batch=MEDIA_FP32_STEPS)
        secs[dev] = time.perf_counter() - t0
    g, c = dets["cuda"], dets["cpu"]
    require_media_dets("media-fp32 CPU", c)
    same = np.array_equal(g["labels"], c["labels"])
    err = (max(float(np.abs(g["segments"] - c["segments"]).max()),
               float(np.abs(g["scores"] - c["scores"]).max()))
           if same else float("inf"))
    log(f"[media-fp32] {MEDIA_FP32_STEPS} timesteps, {len(c['scores'])} "
        f"detections: labels equal {same}, segments and scores card vs CPU "
        f"{err:.3e} (tol {SLICE_TOL}); card {secs['cuda']:.2f} s, CPU "
        f"{secs['cpu']:.2f} s")
    require(same and err <= SLICE_TOL, f"media fp32 card vs CPU: labels "
            f"equal {same}, {err}")
    return {"card_vs_cpu": err, "detections": len(c["scores"]),
            "cpu_s": secs["cpu"]}


def phase_media_int8(models, state_dict, batch2, frames, specs):
    """21d: ``DetectionServer.quantized`` (int8 static, fused heads, bf16)
    over the 40 s video with 21a's int8 backbones
    (``make_visual_apply(--quantize_backbone on)``, dynamic), stream mode:
    kernels 4 and 5 24 times a forward, kernel 3 twice a batch."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import DetectionServer
    n_steps = int(round(MEDIA_SECONDS / MEDIA_HOP))
    video = media_inputs(n_steps, frames, specs)
    cfg = C.epic_detection(compute_dtype="bfloat16", quant_pallas_heads=True)
    server = DetectionServer.quantized(cfg, state_dict, [batch2],
                                       device="cuda", batch_size=MEDIA_BATCH,
                                       top_k=8)
    server.media_audio = audio_apply("cuda")
    threshold = media_threshold(server, models, video)
    dets, wall, launches = media_call(server, models, video, "stream",
                                      threshold, count_launches=True)
    require_media_dets("media-int8", dets)
    n_batches = -(-len(server._window_starts(MEDIA_SECONDS)) // MEDIA_BATCH)
    media_launches_expected("media-int8", launches, n_steps, n_batches,
                            ("window_attention", "flash_mha",
                             "query_block_attention"))
    require(launches["int8_matmul_fused"] == 2 * n_batches,
            f"media-int8: kernel 3 launched {launches['int8_matmul_fused']}"
            f" times, expected 2 x {n_batches}")
    log(f"[media-int8] {wall:.3f} s: {MEDIA_SECONDS / wall:.3f}x real time,"
        f" {len(dets['scores'])} detections (threshold {threshold:.6f}); "
        f"launches {launches}")
    del server, models
    torch.cuda.empty_cache()
    return launches, {"wall_s": wall, "real_time": MEDIA_SECONDS / wall,
                      "detections": len(dets["scores"])}


def phase_media(state_dict, batch2):
    """Phase 21; returns the launches by path."""
    rng = np.random.default_rng(SEED + 3)
    n_long = int(round(MEDIA_LONG_SECONDS / MEDIA_HOP))
    n_frames = max(int(t.max()) for t in media_tables(n_long)) + 1
    t0 = time.perf_counter()
    frames = rng.integers(0, 256, (n_frames, MEDIA_RES, MEDIA_RES, 3),
                          dtype=np.uint8)
    specs = (rng.normal(size=(n_long, *MEDIA_SPEC, 1)) * 0.1).astype(
        np.float32)
    log(f"[media] {len(frames)} uint8 frames ({frames.nbytes / 1e6:.1f} MB) "
        f"and {n_long} spectrograms made in {time.perf_counter() - t0:.2f} s")
    clips = {name: np.random.default_rng(SEED).normal(
        size=(2, *BACKBONES[name][1])).astype(np.float32)
        for name in BACKBONES}
    bf16_models = media_backbones("bfloat16", "cuda")
    paths, summary, int8_models = timed(
        "int8-backbones", phase_int8_backbones, clips, bf16_models)
    media_paths, summary["serving"] = timed(
        "media-serving", phase_media_serving, bf16_models, state_dict,
        frames, specs)
    del bf16_models
    paths.update(media_paths)
    summary["fp32"] = timed("media-fp32", phase_media_fp32, state_dict,
                            frames, specs)
    paths["media-int8"], summary["int8"] = timed(
        "media-int8", phase_media_int8, int8_models, state_dict, batch2,
        frames, specs)
    log(f"[media] summary {json.dumps(summary)}")
    return paths


# ---------------------------------------------------------------------------
# Phase 22: the backbone finetune CLI (``extract/finetune_cli.py``) at
# ViT-L's full width (embed 1024, depth 24, 16 heads, 16 x 224^2, tubelet
# 2; 97 verbs, 300 nouns), bf16, batch 8, on synthetic uint8 EPIC-sized
# frames from a seeded reader and ``dict`` annotations; the finetune clips
# take the recipe's ``VideoRandAugment`` (Pillow's ops of the port's own)
# with PIL blocked, ``random`` and ``np.random`` seeded before each run.
# ---------------------------------------------------------------------------
FT_SEGMENTS = 24           # annotation rows: 3 steps of batch 8 a mode
FT_BATCH = 8
FT_FRAME_HW = (256, 456)   # EPIC-KITCHENS frames
FT_PER_STEP = {"pretrain": 36, "finetune": 24}   # kernel 5 / 5b a step
FT_METRIC_RTOL = 1e-4      # fp32 slice card vs CPU: the step's metrics
FT_GRAD_TOL = 1e-4         # and every gradient, of each one's largest


def ft_annotations(n, seed):
    """``n`` EPIC-style segments of 4 videos as a ``dict`` of arrays."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, 400, n)
    return {"video_id": np.asarray([f"P01_{i % 4:02d}" for i in range(n)]),
            "start_frame": start,
            "stop_frame": start + rng.integers(20, 120, n),
            "verb_class": rng.integers(0, 97, n),
            "noun_class": rng.integers(0, 300, n)}


def ft_reader(video_id, indices, offset):
    """Seeded uint8 frames [T, 256, 456, 3], a function of the video, the
    frame and the segment's offset (the reader ``jpeg_frame_reader``
    stands for)."""
    h, w = FT_FRAME_HW
    vid = int(video_id.rsplit("_", 1)[1])
    return np.stack([np.random.default_rng([vid, int(i) + int(offset)])
                     .integers(0, 256, (h, w, 3), np.uint8)
                     for i in indices])


def ft_args(mode, out, *extra):
    from tim_tpu_torch.extract import finetune_cli
    return finetune_cli.build_parser().parse_args(
        ["--mode", mode, "--anno_train", "unused.csv", "--data_path",
         "unused", "--output_dir", str(out), "--epochs", "1",
         "--warmup_epochs", "0", "--batch_size", str(FT_BATCH),
         "--seed", str(SEED), *extra])


def ft_datasets(args, n, seed=SEED + 7):
    """``finetune_cli.datasets`` with its default RandAugment: identity
    for pretraining, the recipe's ``VideoRandAugment`` for finetuning."""
    from tim_tpu_torch.extract import finetune_cli
    return finetune_cli.datasets(args, ft_annotations(n, seed), None,
                                 ft_reader)


class StepClock:
    """Per-step phase times of a backbone runner: ``runner.backbone.
    _batches`` wrapped so that each fetch is timed (``PhaseTimer``: data =
    the host making a batch of clips, net = the step, read at the next
    fetch after a synchronize), and the step's device ms (CUDA events
    recorded when the batch is handed over and when the next is asked
    for)."""

    def __init__(self):
        from tim_tpu_torch.runner import backbone as rb
        from tim_tpu_torch.utils.logging import PhaseTimer
        self.module, self.orig = rb, rb._batches
        self.timer, self.steps = PhaseTimer(), []

    def __enter__(self):
        orig, timer, steps = self.orig, self.timer, self.steps

        def batches(*a, **kw):
            it = orig(*a, **kw)
            timer.iter_tic()
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                timer.data_toc()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield batch
                end.record()
                torch.cuda.synchronize()
                timer.net_toc()
                timer.iter_toc()
                steps.append((timer.data_time, timer.net_time,
                              timer.iter_time, start.elapsed_time(end)))
                timer.iter_tic()

        self.module._batches = batches
        return self

    def __exit__(self, *exc):
        self.module._batches = self.orig


def ft_cli_run(tag, mode, args, train_ds, val_ds, per=None):
    """``finetune_cli.run`` on the card, every count set to 0 just before
    and read just after; the train steps' phase times and peak memory.
    Returns (stats, launches, step times, seconds)."""
    from tim_tpu_torch.extract import finetune_cli
    from tim_tpu_torch.utils.memory import memory_summary
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    t0 = time.perf_counter()
    with StepClock() as clock:
        stats = finetune_cli.run(args, train_ds, val_ds, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    steps = clock.steps
    train_steps = len(train_ds) // FT_BATCH
    val_batches = 0 if val_ds is None else -(-len(val_ds) // FT_BATCH)
    clips = FT_BATCH * (args.num_sample if mode == "finetune" else 1)
    last = steps[train_steps - 1]
    log(f"[{tag}] finetune_cli.run --mode {mode}: {secs:.3f} s; "
        f"{train_steps} steps of {clips} clips ({FT_BATCH} segments), per "
        f"step data / net / wall s "
        f"{[tuple(round(x, 4) for x in s) for s in steps[:train_steps]]}; "
        f"last step {last[2]:.3f} s, {clips / last[2]:.2f} wall clips/s, "
        f"host share {last[0] / last[2]:.3f}; {memory_summary('cuda')}; "
        f"peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; stats "
        f"{json.dumps(stats)}; launches {launches}")
    per = FT_PER_STEP[mode] if per is None else per
    require(launches["flash_mha"] == per * train_steps
            + args.depth * val_batches
            and launches["flash_mha_bwd"] == per * train_steps
            and launches["window_attention"] == 0
            and launches["query_block_attention"] == 0,
            f"{tag}: launches {launches}, expected {per} of kernels 5 and 5b "
            f"a step ({train_steps} steps) and 24 of kernel 5 a validation "
            f"batch ({val_batches})")
    require(all(np.isfinite(float(v)) for v in stats.values()),
            f"{tag}: non-finite statistics {stats}")
    return stats, launches, {
        "steps": train_steps, "clips_per_step": clips,
        "step_s": [s[2] for s in steps[:train_steps]],
        "data_s": [s[0] for s in steps[:train_steps]],
        "net_s": [s[1] for s in steps[:train_steps]],
        "device_ms": [s[3] for s in steps[:train_steps]],
        "wall_clips_per_s": clips / last[2],
        "host_share": last[0] / last[2], "seconds": secs,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches_per_step": {
            "flash_mha": (launches["flash_mha"] - args.depth * val_batches)
            / train_steps,
            "flash_mha_bwd": launches["flash_mha_bwd"] / train_steps}}


def ft_cli_slice_fp32(out):
    """The finetune CLI in fp32 at reduced depth (2 blocks, one step of 2
    segments, mixup on): the step's metrics and every gradient, card
    (kernels 5 and 5b) against the CPU (plain versions); the clips'
    RandAugment draws seeded alike on both."""
    import random
    from tim_tpu_torch.extract import finetune_cli
    from tim_tpu_torch.runner import backbone as rb
    from tim_tpu_torch.train.state import TrainState
    results = {}
    for device in ("cuda", "cpu"):
        args = ft_args("finetune", out / f"slice-{device}", "--depth", "2",
                       "--batch_size", "2", "--num_sample", "1",
                       "--compute_dtype", "float32")
        train_ds, val_ds = ft_datasets(args, 2)
        seen = {}
        apply, fit = TrainState.apply_gradients, rb.BackboneFinetuneRunner.fit

        def capture(state, *a, **kw):
            seen["grads"] = {n: p.grad.detach().float().cpu().clone()
                             for n, p in state.model.named_parameters()}
            return apply(state, *a, **kw)

        def fit_capture(runner):
            seen["metrics"] = fit(runner)
            return seen["metrics"]

        TrainState.apply_gradients = capture
        rb.BackboneFinetuneRunner.fit = fit_capture
        try:
            random.seed(SEED + 23)
            np.random.seed(SEED + 23)
            t0 = time.perf_counter()
            finetune_cli.run(args, train_ds, val_ds, device=device)
            seen["seconds"] = time.perf_counter() - t0
        finally:
            TrainState.apply_gradients = apply
            rb.BackboneFinetuneRunner.fit = fit
        results[device] = seen
    card, cpu = results["cuda"], results["cpu"]
    for k, want in cpu["metrics"].items():
        got = card["metrics"][k]
        require(abs(got - want) <= FT_METRIC_RTOL * max(abs(want), 1e-30),
                f"ft-cli-slice: {k} card {got} vs CPU {want}")
    worst, worst_name = 0.0, ""
    for name, want in cpu["grads"].items():
        got = card["grads"][name]
        require(bool(torch.isfinite(got).all()), f"ft-cli-slice {name}")
        rel = max_err(got, want) / max(want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[ft-cli-slice] fp32, depth 2, one step: metrics card "
        f"{json.dumps(card['metrics'])}, CPU {json.dumps(cpu['metrics'])}; "
        f"{len(cpu['grads'])} gradients within {worst:.3e} of each one's "
        f"largest (worst {worst_name}; tol {FT_GRAD_TOL}); CPU run "
        f"{cpu['seconds']:.2f} s, card {card['seconds']:.2f} s")
    require(worst <= FT_GRAD_TOL, f"ft-cli-slice: gradient {worst_name} "
            f"card vs CPU {worst} of its largest > {FT_GRAD_TOL}")
    return worst


class Recorded:
    """Within the block, ``owner.attr`` (a function) keeps what each call
    returns, or with ``factory`` what each call of the function that each
    call returns returns (a step function's metrics)."""

    def __init__(self, owner, attr, factory=False):
        self.owner, self.attr, self.factory = owner, attr, factory
        self.orig, self.values = getattr(owner, attr), []

    def __enter__(self):
        orig, values = self.orig, self.values

        def keep(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                values.append(out)
                return out
            return call

        setattr(self.owner, self.attr,
                (lambda *a, **kw: keep(orig(*a, **kw))) if self.factory
                else keep(orig))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def jax_mae_checkpoint(state, tmp, trunk, missing_pt, card):
    """25d, first half: the pretraining state (``PretrainVideoMAE`` at
    ViT-L width, ``torch.optim.AdamW``) written as the JAX package's
    msgpack file, decoded back, and merged into a ViT-L trunk as the
    finetune CLI's ``--pretrained`` merges it: the same missing entries
    as the .pt route's. Returns the directory."""
    from tim_tpu_torch.extract import finetune_cli
    from tim_tpu_torch.train import checkpoint as ckpt
    from tim_tpu_torch.utils import msgpack
    out = tmp / "pre_jax"
    t0 = time.perf_counter()
    nbytes = ckpt.save_jax_checkpoint(str(out), state, epoch=1)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = msgpack.load(str(out / "checkpoint.msgpack"))
    read_s = time.perf_counter() - t0
    count = int(payload["opt_state"]["0"]["count"])
    require(count == int(state.optimizer.state_dict()["state"][0]["step"])
            and int(payload["step"]) == state.step,
            f"jax-ckpt-mae: Adam count {count}, step {int(payload['step'])}")
    del payload
    params, missing = finetune_cli.load_pretrained_encoder(str(out), trunk)
    require(missing == missing_pt, f"jax-ckpt-mae: --pretrained from "
            f"msgpack misses {missing}, from .pt {missing_pt}")
    del params
    log(f"[jax-ckpt-mae] {card}: PretrainVideoMAE state ({state.step} steps) "
        f"checkpoint.msgpack {nbytes} bytes, written in {write_s:.3f} s "
        f"({rate(nbytes, write_s):.1f} MB/s), decoded in {read_s:.3f} s "
        f"({rate(nbytes, read_s):.1f} MB/s); the trunk misses {missing}, as "
        f"from the .pt file")
    return out, {"bytes": nbytes, "write_s": write_s, "read_s": read_s,
                 "write_mb_s": rate(nbytes, write_s),
                 "read_mb_s": rate(nbytes, read_s)}


def phase_finetune_cli(card: str):
    """Phase 22: MAE pretraining through the CLI (mask 0.9), then the
    finetune mode warm-started from its ``checkpoint.pt`` (num_sample 2,
    mixup 0.8) and its validation; then the fp32 slice card vs CPU. Phase
    25d runs here, on the pretraining state: written as msgpack, the same
    finetune warm-started from it, its first step's loss bit-equal to the
    .pt route's."""
    import pathlib
    import tempfile
    from tim_tpu_torch.extract import finetune_cli
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    from tim_tpu_torch.runner import backbone as rb
    import random
    from tim_tpu_torch.extract.autoaug import VideoRandAugment
    log("[ft-cli] finetune clips take the recipe's VideoRandAugment "
        "(rand-m7-n4-mstd0.5-inc1, bicubic; extract.imageops) with PIL "
        "blocked, random and np.random seeded before each run; frames are "
        f"seeded uint8 arrays {FT_FRAME_HW[0]} x {FT_FRAME_HW[1]} (phase 29 "
        "reads JPEGs)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        args = ft_args("pretrain", tmp / "pre", "--mask_ratio", "0.9")
        train_ds, _ = ft_datasets(args, FT_SEGMENTS)
        with Recorded(rb.BackbonePretrainRunner, "init_state") as pre_state:
            pre_stats, pre_l, pre_m = timed(
                "ft-cli-pretrain", ft_cli_run, "ft-cli-pretrain", "pretrain",
                args, train_ds, None)
        path = str(tmp / "pre" / "checkpoint.pt")
        trunk = VideoMAEViT(device="cpu")
        params, missing = finetune_cli.load_pretrained_encoder(path, trunk)
        total = len(trunk.state_dict())
        blocks = [k for k in trunk.state_dict() if k.startswith("blocks.")]
        require(all(k in params for k in blocks)
                and missing == ["fc_norm.weight", "fc_norm.bias"],
                f"ft-cli: the pretrained encoder misses {missing}")
        log(f"[ft-cli] --pretrained {path}: {total - len(missing)} of "
            f"{total} trunk entries load ({len(blocks)} of blocks.*), "
            f"missing {missing}")
        del params
        jax_dir, jax_mae = timed("jax-ckpt-mae", jax_mae_checkpoint,
                                 pre_state.values[0], tmp, trunk, missing,
                                 card)
        del trunk, pre_state
        torch.cuda.empty_cache()
        runs = {}
        for tag, pretrained in (("ft-cli-finetune", path),
                                ("jax-ft-cli-finetune", str(jax_dir))):
            args = ft_args("finetune", tmp / tag, "--pretrained", pretrained,
                           "--num_sample", "2", "--mixup", "0.8")
            saved = block_modules(("PIL",))
            try:
                train_ds, val_ds = ft_datasets(args, FT_SEGMENTS)
                require(isinstance(train_ds.rand_augment, VideoRandAugment),
                        f"{tag}: RandAugment {type(train_ds.rand_augment)}")
                random.seed(SEED + 22)
                np.random.seed(SEED + 22)
                with Recorded(rb, "make_two_head_step",
                              factory=True) as steps:
                    runs[tag] = timed(tag, ft_cli_run, tag, "finetune",
                                      args, train_ds, val_ds)
            finally:
                unblock_modules(saved)
            runs[tag] += (steps.values[0]["loss"],)
            os.remove(tmp / tag / "checkpoint.pt")
        ft_stats, ft_l, ft_m, first = runs["ft-cli-finetune"]
        require(sorted(ft_stats) == ["noun_top1", "verb_top1"],
                f"ft-cli-finetune: statistics {ft_stats}")
        jax_first = runs["jax-ft-cli-finetune"][3]
        require(torch.equal(first, jax_first),
                f"jax-ft-cli-finetune: first step loss {float(jax_first)} vs "
                f"the .pt route's {float(first)}")
        log(f"[jax-ckpt-mae] finetune CLI --pretrained checkpoint.msgpack: "
            f"first ViT-L step loss {float(jax_first):.7f}, bit-equal to the "
            f".pt route's")
        worst = timed("ft-cli-slice-fp32", ft_cli_slice_fp32, tmp)
    summary = {"pretrain": pre_m, "finetune": ft_m,
               "encoder_entries_loaded": total - len(missing),
               "slice_fp32_worst_grad": worst, "jax_mae_checkpoint": jax_mae,
               "jax_finetune": runs["jax-ft-cli-finetune"][2]}
    log(f"[ft-cli] summary {json.dumps(summary)}")
    return {"ft-cli-pretrain": pre_l, "ft-cli-finetune": ft_l,
            "jax-ft-cli-finetune": runs["jax-ft-cli-finetune"][1]}


# ---------------------------------------------------------------------------
# Phase 23: the data-parallel path on the card: a process group of one
# rank over NCCL (the machine has one card; two ranks run in the CPU tests,
# tests/test_torch_parallel.py), ``cli.run`` --train (3 steps) with its
# validation and the dump, detection and recognition, each bit-equal to
# the same run without a process group; then the group's cost on a train
# step and a dump, each timed alone (``dp_costs``).
# ---------------------------------------------------------------------------
DP_STEPS, DP_VAL_BATCHES = 3, 2
# the one-rank group's cost: train steps and dumps timed one by one after
# a warm-up, the plain runner before and after the group's
DP_TIMED, DP_WARMUP = 20, 3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_group_of_one() -> float:
    """A process group of one rank over NCCL (``multihost.initialize``
    joins none for one process, as JAX's does); returns its seconds."""
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0)
    require(torch.distributed.get_backend() == "nccl",
            f"dp: backend {torch.distributed.get_backend()}")
    return time.perf_counter() - t0


def each_ms(fn, n=DP_TIMED, warmup=DP_WARMUP):
    """(device ms between CUDA events, wall ms) of each of ``n`` calls of
    ``fn`` after ``warmup`` calls, each call synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, wall = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return dev, wall


def median(xs):
    return float(np.median(xs))


def dp_timed_runner(variant, train_ds, val_ds, out):
    """The CLI's runner (banked) and the calls to time: one train step on
    the split's first batch, and the dump (detection: top-8)."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.data.device_bank import host_to_device
    runner = cli.make_runner(cli_args(variant, out), train_ds, val_ds,
                             device="cuda")
    bs = runner.tcfg.batch_size
    batch = runner._tables.batch(host_to_device(
        torch.arange(bs)[runner._share], runner.device))
    if variant == "detection":
        dump = lambda: runner.extract_dense_predictions(  # noqa: E731
            top_k=CLI_TOPK)
    else:
        dump = runner.extract_predictions
    return (runner, lambda: runner._bank_step(runner.state, batch), dump)


class CallEvents:
    """CUDA events around every call of ``owner.name`` (a module's function
    or an instance's method, wrapped in place while inside): the device ms
    that the calls took."""

    def __init__(self, owner, name):
        self.owner, self.name, self.events = owner, name, []

    def __enter__(self):
        orig, events = getattr(self.owner, self.name), self.events
        self.own = self.name in vars(self.owner)
        self.orig = orig

        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.owner, self.name, self.orig)
        else:
            delattr(self.owner, self.name)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def each_ms_by_call(fn, owners):
    """``each_ms(fn)`` with the device ms a call of ``fn`` spent in each
    of ``owners`` ((object, attribute) pairs: the collectives)."""
    watches = [CallEvents(o, n) for o, n in owners]
    for w in watches:
        w.__enter__()
    try:
        dev, wall = each_ms(fn)
    finally:
        for w in reversed(watches):
            w.__exit__()
    calls = DP_WARMUP + DP_TIMED
    return dev, wall, {w.name: w.ms() / calls for w in watches}


def dp_costs(variant, train_ds, val_ds, out):
    """The one-rank NCCL group's cost on the CLI's runner: the median of
    ``DP_TIMED`` train steps and dumps, each timed alone, plain (before
    the group), in the group, plain again. In the group also: the first
    collective (the communicator); the device ms a step and a dump spend
    in each collective helper; the gradient bucket alone, and its copy
    back as one ``_foreach_copy_`` against a ``copy_`` a tensor."""
    from tim_tpu_torch.parallel import multihost
    plain, p_step, p_dump = dp_timed_runner(variant, train_ds, val_ds, out)
    res = {"plain": {"step": each_ms(p_step), "dump": each_ms(p_dump)}}
    res["group_s"] = join_group_of_one()
    try:
        t0 = time.perf_counter()
        multihost.allreduce_host_array(np.zeros(1))
        res["first_collective_s"] = time.perf_counter() - t0
        grouped, g_step, g_dump = dp_timed_runner(variant, train_ds, val_ds,
                                                  out)
        mesh = grouped.mesh
        helpers = [(mesh, "sync_gradients"), (mesh, "all_gather"),
                   (mesh, "all_reduce_sum"),
                   (multihost, "allgather_host_arrays"),
                   (multihost, "allreduce_host_array")]
        *step, res["step_in_collectives_ms"] = each_ms_by_call(g_step,
                                                               helpers)
        *dump, res["dump_in_collectives_ms"] = each_ms_by_call(g_dump,
                                                               helpers)
        res["group"] = {"step": step, "dump": dump}
        params = list(grouped.model.parameters())
        grads = [torch.zeros_like(p) for p in params]
        zero = torch.zeros((), device="cuda")
        for p, g in zip(params, grads):
            p.grad = g
        res["group"]["gradient_bucket"] = each_ms(
            lambda: mesh.sync_gradients(params, [zero]))
        flat = torch.cat([g.reshape(-1) for g in grads])
        pieces = [q.view(g.shape) for g, q in
                  zip(grads, flat.split([g.numel() for g in grads]))]
        res["group"]["copy_back_foreach"] = each_ms(
            lambda: torch._foreach_copy_(grads, pieces))
        res["group"]["copy_back_per_tensor"] = each_ms(
            lambda: [g.copy_(q) for g, q in zip(grads, pieces)])
        res["bucket_tensors"] = len(params)
        res["bucket_mib"] = flat.numel() * flat.element_size() / 2 ** 20
        grouped.model.zero_grad(set_to_none=True)
        del flat, pieces, grads
    finally:
        multihost.finalize()
    res["plain_again"] = {"step": each_ms(p_step), "dump": each_ms(p_dump)}
    del plain, grouped
    torch.cuda.empty_cache()
    summary = {k: res[k] for k in (
        "group_s", "first_collective_s", "bucket_tensors", "bucket_mib",
        "step_in_collectives_ms", "dump_in_collectives_ms")}
    for run in ("plain", "group", "plain_again"):
        for what, (dev, wall) in res[run].items():
            summary[f"{run}_{what}_ms"] = {"device": median(dev),
                                           "wall": median(wall)}
    for what in ("step", "dump"):
        base = min(summary[f"{run}_{what}_ms"]["device"]
                   for run in ("plain", "plain_again"))
        summary[f"group_{what}_extra"] = (
            summary[f"group_{what}_ms"]["device"] / base - 1.0)
    log(f"[dp-{variant}] one-rank NCCL cost, medians of {DP_TIMED} calls "
        f"after {DP_WARMUP} (device ms between CUDA events / wall ms; in "
        f"collectives: device ms a call): {json.dumps(summary)}")
    return summary


class StepCollectives:
    """The collective calls between consecutive optimizer updates (a
    train step's), read at each ``TrainState.apply_gradients``."""

    def __init__(self):
        from tim_tpu_torch.parallel import multihost
        from tim_tpu_torch.train.state import TrainState
        self.multihost, self.cls = multihost, TrainState
        self.apply, self.marks = TrainState.apply_gradients, []

    def __enter__(self):
        apply, marks, mh = self.apply, self.marks, self.multihost

        def counted(state, *a, **kw):
            marks.append(mh.collective.calls)
            return apply(state, *a, **kw)

        self.cls.apply_gradients = counted
        return self

    def __exit__(self, *exc):
        self.cls.apply_gradients = self.apply

    def per_step(self):
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def dp_runs(variant, train_ds, val_ds, out):
    """``--train`` one epoch, then ``--extract_feats`` resumed from its
    checkpoint (detection: top-8). Returns (train statistics, parameters,
    dump, launches by run, collectives: total and per step)."""
    from tim_tpu_torch.parallel import multihost
    extra = ["--extract_top_k", str(CLI_TOPK)] if variant == "detection" \
        else []
    tag = f"dp-{variant[:3]}"
    multihost.collective.calls = 0
    with StepCollectives() as steps:
        stats, l_train, s_train = cli_run(
            f"{tag}-train", cli_args(variant, out, "--train",
                                     "--finetune_epochs", "1"),
            train_ds, val_ds)
    train_calls = multihost.collective.calls
    payload = torch.load(out / "checkpoint.pt", map_location="cpu",
                         weights_only=True)
    multihost.collective.calls = 0
    dump, l_dump, s_dump = cli_run(
        f"{tag}-dump", cli_args(variant, out, "--extract_feats", "--resume",
                                str(out), *extra), None, val_ds)
    return (stats, payload["params"], dump,
            {f"{tag}-train": l_train, f"{tag}-dump": l_dump},
            {"train": train_calls, "per_step": steps.per_step(),
             "updates": len(steps.marks), "dump": multihost.collective.calls,
             "seconds": (s_train, s_dump)})


def dp_equal(tag, got, want):
    """Bit-equality of two runs' statistics, parameters and dumps."""
    g_stats, g_params, g_dump = got[:3]
    w_stats, w_params, w_dump = want[:3]
    require(g_stats == w_stats, f"{tag}: statistics {g_stats} vs "
            f"{w_stats}")
    require(sorted(g_params) == sorted(w_params) and all(
        torch.equal(g_params[k], w_params[k]) for k in w_params),
        f"{tag}: parameters differ")
    require(sorted(g_dump) == sorted(w_dump), f"{tag}: dump keys differ")
    for k, w in w_dump.items():
        g = g_dump[k]
        same = (g == w if isinstance(w, list)
                else np.array_equal(np.asarray(g), np.asarray(w)))
        require(same, f"{tag}: dump column {k} differs")


def phase_data_parallel(det_splits, rec_splits):
    """Phase 23; returns the launches by path."""
    import pathlib
    import tempfile
    from tim_tpu_torch.parallel import multihost
    det_train, det_val = det_splits
    rec_train, rec_val = rec_splits
    splits = {
        "detection": (
            epic_detection_split(det_subset(det_train, DP_STEPS * DET_BATCH),
                                 True),
            epic_detection_split(det_subset(det_val,
                                            DP_VAL_BATCHES * DET_BATCH),
                                 False)),
        "recognition": (det_subset(rec_train, DP_STEPS * REC_BATCH),
                        det_subset(rec_val, DP_VAL_BATCHES * REC_BATCH))}
    paths, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for variant, (train_ds, val_ds) in splits.items():
            (tmp / variant / "plain").mkdir(parents=True)
            (tmp / variant / "group").mkdir(parents=True)
            plain = dp_runs(variant, train_ds, val_ds, tmp / variant / "plain")
            require(plain[4]["train"] == 0 and plain[4]["dump"] == 0,
                    f"dp-{variant}: collectives without a process group")
            init_s = join_group_of_one()
            try:
                grouped = dp_runs(variant, train_ds, val_ds,
                                  tmp / variant / "group")
            finally:
                multihost.finalize()
            dp_equal(f"dp-{variant}", grouped, plain)
            calls = grouped[4]
            require(plain[4]["updates"] == calls["updates"] == DP_STEPS,
                    f"dp-{variant}: {calls['updates']} optimizer updates, "
                    f"expected {DP_STEPS}")
            require(calls["per_step"] and min(calls["per_step"]) > 0,
                    f"dp-{variant}: no collective in a train step "
                    f"({calls})")
            paths.update(grouped[3])
            summary[variant] = {
                "steps": len(train_ds) // (DET_BATCH if variant == "detection"
                                           else REC_BATCH),
                "collectives_per_step": calls["per_step"],
                "collectives_train_run": calls["train"],
                "collectives_dump": calls["dump"],
                "nccl_init_s": init_s,
                "seconds_plain": plain[4]["seconds"],
                "seconds_nccl": calls["seconds"]}
            log(f"[dp-{variant}] one-rank NCCL group (init {init_s:.3f} s): "
                f"--train and the dump bit-equal to the runs without a "
                f"group (statistics, every parameter, every dump column); "
                f"collectives per step {calls['per_step']}, the train run "
                f"{calls['train']}, the dump {calls['dump']}; seconds "
                f"plain {plain[4]['seconds']}, NCCL {calls['seconds']}")
            (tmp / variant / "timed").mkdir()
            summary[variant]["cost"] = dp_costs(variant, train_ds, val_ds,
                                                tmp / variant / "timed")
    log("[dp] one card on this machine: two ranks run only in the CPU "
        "tests (tests/test_torch_parallel.py, gloo)")
    log(f"[dp] summary {json.dumps(summary)}")
    for variant, per_batch in (("det", 6), ("rec", 4)):
        for run in ("train", "dump"):
            launches = paths[f"dp-{variant}-{run}"]
            require(launches["query_block_attention"] > 0
                    and launches["query_block_attention"] % per_batch == 0,
                    f"dp-{variant}-{run}: kernel 1 launches {launches}")
    return paths


# ---------------------------------------------------------------------------
# Phase 24: tensor and sequence parallelism on the card. The machine has one
# card and NCCL refuses two ranks on one device, so two processes share
# cuda:0 over gloo with CUDA tensors (data 1 x model 2;
# ``multihost.collective`` stages the collectives gloo has no CUDA route for
# through host memory, and logs them). ``DetectionRunner`` with
# ``MeshConfig(1, 2)`` on EPIC detection at full width and depth (encoder
# 1024, 8 heads, 6 layers, 3806 + 44 classes, S = 898), bf16: 3 banked train
# steps at a global batch of 16 (a cut: phase 16 trains at 64), the
# validation of one batch (kernel 1 at [16, 4, 798, 128], six times a rank)
# and its top-8 dump, with sequence parallelism off and on; an fp32 slice of
# 2 layers; ``use_fused_ffn`` validation on the trained weights (kernel 2 on
# the gathered FFN weights). Each against the same runs in one process;
# then the ranks' checkpoint loaded strictly into a one-process
# ``TimDetection``, and ``dryrun_multichip(1)``. gloo on one card: the step
# times are not a tensor-parallel speed.
# ---------------------------------------------------------------------------
TP_BATCH, TP_STEPS = 16, 3
TP_DEVICE = "cuda"
TP_SCRIPT = os.path.abspath(__file__)    # the ranks run this file
TP_SLICE_TOL = 1e-4     # fp32 slice: of each tensor's largest value; losses
# bf16 top-8 scores against bf16 (two ranks vs one process, use_fused_ffn
# vs the unfused sharded run, the ranks' checkpoint in one process): the
# same precision, so tighter than BF16_SCORE_TOL (bf16 vs fp32); measured
# 1.39e-3 to 1.79e-3 (PERF.md, PR 14). Two faulty copies of the dump must
# lie outside it (``tp_score_controls``).
TP_SCORE_TOL = 1e-2
# The key bias's gradient is zero in exact arithmetic (it adds one constant
# to every score of a query), so both runs step it by Adam on rounding
# noise: the key third of each in_proj_bias is held to this share of the
# tensor's largest value instead (measured 1.4e-3 in a CPU run at width 32)
TP_KEY_BIAS_TOL = 1e-2
TP_TIMEOUT = 900
TP_RUNS = {             # name: epic_detection overrides
    "fp32-slice": dict(compute_dtype="float32", num_layers=2),
    "bf16": {},
    "bf16-sp": dict(sequence_parallel=True),
}


def tp_splits():
    """The phase's train (3 batches) and validation (1 batch) windows,
    built alike in every process from the seed."""
    from tim_tpu_torch import config as C
    cfg = C.epic_detection()
    rng = np.random.default_rng(SEED + 24)
    train, val = det_split(cfg, 1, rng), det_split(cfg, 1, rng)
    return det_subset(train, TP_STEPS * TP_BATCH), det_subset(val, TP_BATCH)


def tp_validate(runner):
    """(validation losses, launches, top-8 dump values, kernel 1's inputs
    of its first launch), every count set to 0 just before and read just
    after the validation."""
    from tim_tpu_torch.ops import attention as att
    captured = []
    launch = att.query_block_attention

    def capture(*args):
        if not captured:
            captured.append([a.detach().clone() for a in args])
        return launch(*args)

    att.query_block_attention = capture
    try:
        counters = zero_counts()
        losses = runner.validate()
        launches = read_counts(counters)
    finally:
        att.query_block_attention = launch
    dump = runner.extract_dense_predictions(top_k=CLI_TOPK)
    tops = {k: np.asarray(dump[k]) for k in ("action_topk_values",
                                             "audio_topk_values")}
    return losses, launches, tops, captured[0] if captured else None


def tp_run(name, mesh_cfg, splits, out):
    """One run of phase 24 in this process (a rank of the group, or one
    process): 3 train steps, each timed (synchronised) with its metrics and
    collectives; the validation and dump; kernel 1's first launch against
    its plain version; the state saved to ``out/name``; the fp32 slice's
    whole parameters; after ``bf16-sp``, the ``use_fused_ffn``
    validation."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.parallel import multihost
    from tim_tpu_torch.runner.detection import DetectionRunner
    from tim_tpu_torch.train import checkpoint as ckpt
    cfg = C.epic_detection(**TP_RUNS[name])
    tcfg = C.TrainConfig(batch_size=TP_BATCH, epochs=1, seed=SEED)
    train_ds, val_ds = splits
    runner = DetectionRunner(cfg, tcfg, train_ds, val_ds, mesh_cfg=mesh_cfg,
                             print_freq=1000, use_device_bank=True,
                             device=TP_DEVICE)
    runner.init_state()
    res = {"steps": [], "step_s": [], "collectives": [],
           "mesh": runner.mesh.shape}
    step = runner._bank_step

    def timed_step(state, batch):
        torch.cuda.synchronize()
        calls, t0 = multihost.collective.calls, time.perf_counter()
        metrics = {k: float(v) for k, v in step(state, batch).items()}
        torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["collectives"].append(multihost.collective.calls - calls)
        res["steps"].append(metrics)
        return metrics

    runner._bank_step = timed_step
    counters = zero_counts()
    runner.train_epoch(0)
    res["train_launches"] = read_counts(counters)
    runner._bank_step = step
    require(len(res["steps"]) == TP_STEPS,
            f"tp-{name}: {len(res['steps'])} steps, expected {TP_STEPS}")
    res["val"], res["val_launches"], res["dump"], args = tp_validate(runner)
    require(args is not None, f"tp-{name}: kernel 1 never launched")
    want = qba.query_block_attention_plain(*args)
    got = qba.query_block_attention(*args)
    res["qba_shape"] = tuple(args[0].shape)
    res["qba"] = query_block_close(got, want)
    ckpt.save_checkpoint(os.path.join(out, name), runner.state, epoch=1)
    whole = runner.model.full_state_dict()      # every rank gathers
    if cfg.compute_dtype == "float32" and multihost.is_master():
        res["params"] = {k: v.detach().cpu() for k, v in whole.items()}
    if name == "bf16-sp":
        fused = DetectionRunner(dataclasses.replace(cfg, use_fused_ffn=True),
                                tcfg, None, val_ds, mesh_cfg=mesh_cfg,
                                print_freq=1000, use_device_bank=True,
                                device=TP_DEVICE)
        fused.load_torch_checkpoint(whole)
        fused.state.normaliser = runner.state.normaliser.clone()
        (res["fused_val"], res["fused_launches"], res["fused_dump"],
         _) = tp_validate(fused)
        del fused
    del runner, whole
    torch.cuda.empty_cache()
    return res


def tp_rank_main(rank: int, port: int, out: str) -> int:
    """A rank of phase 24: joins the gloo group of two on cuda:0, runs
    every run of ``TP_RUNS`` and writes ``out/rank<rank>.pt``."""
    from tim_tpu_torch.config import MeshConfig
    from tim_tpu_torch.parallel import multihost
    if TP_DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=2,
        rank=rank)
    splits = tp_splits()
    results = {name: tp_run(name, MeshConfig(1, 2), splits, out)
               for name in TP_RUNS}
    results["staged"] = sorted(multihost.collective.staged)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    multihost.finalize()
    return 0


def rel_diff(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def tp_compare(tag, got, want, loss_tol, score_tol):
    """Losses of every step and of the validation within ``loss_tol``
    relative, the top-8 dump values within ``score_tol``; returns the
    largest differences."""
    out = {"steps": 0.0, "val": 0.0, "dump": 0.0}
    for g, w in zip(got["steps"], want["steps"]):
        for k in w:
            if k.startswith("loss"):
                out["steps"] = max(out["steps"], rel_diff(g[k], w[k]))
    require(sorted(got["val"]) == sorted(want["val"]),
            f"{tag}: validation keys differ")
    out["val"] = max(rel_diff(got["val"][k], want["val"][k])
                     for k in want["val"])
    out["dump"] = max(float(np.abs(got["dump"][k] - want["dump"][k]).max())
                      for k in want["dump"])
    require(out["steps"] <= loss_tol and out["val"] <= loss_tol,
            f"{tag}: losses differ by {out} (tol {loss_tol})")
    require(out["dump"] <= score_tol,
            f"{tag}: top-8 scores differ by {out['dump']} (tol {score_tol})")
    return out


def tp_score_controls(dump):
    """How far two faulty copies of a top-8 dump lie from it (its windows
    shifted by one: scores on the wrong windows; each window's top 8 in
    reverse order: a ranking fault), and its largest score."""
    def worst(fault):
        return max(float(np.abs(fault(v) - v).max()) for v in dump.values())

    return {"shifted": worst(lambda v: np.roll(v, 1, axis=0)),
            "reversed": worst(lambda v: v[..., ::-1]),
            "largest": max(float(np.abs(v).max()) for v in dump.values())}


def phase_tensor_parallel(card: str):
    """Phase 24; returns the launches of the ranks' paths."""
    import pathlib
    import tempfile
    from tim_tpu_torch import config as C
    from tim_tpu_torch.dryrun import dryrun_multichip
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.runner.detection import DetectionRunner
    summary, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, TP_SCRIPT, "--tp-rank", str(r),
             str(port), str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        try:
            logs = [p.communicate(timeout=TP_TIMEOUT)[0].decode(
                errors="replace") for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            for line in text.splitlines():
                if line.startswith(("[", "WARNING", "Traceback")) or \
                        "staged" in line or "Error" in line:
                    log(f"[tp rank {r}] {line}")
            require(p.returncode == 0, f"tp: rank {r} exited "
                    f"{p.returncode}:\n{text[-4000:]}")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"[tp] two ranks on cuda:0 over gloo ({ranks_s:.1f} s); "
            f"collectives staged through host memory: {ranks[0]['staged']}")
        splits = tp_splits()
        one = {name: tp_run(name, C.MeshConfig(), splits, str(tmp / "one"))
               for name in ("fp32-slice", "bf16")}
        for r, rank in enumerate(ranks):
            for name in TP_RUNS:
                res = rank[name]
                require(res["mesh"] == {"data": 1, "model": 2},
                        f"tp-{name}: mesh {res['mesh']}")
                ok, err, rel = res["qba"]
                require(res["qba_shape"] == (TP_BATCH, 4, 798, 128) and ok,
                        f"tp-{name} rank {r}: kernel 1 at {res['qba_shape']} "
                        f"vs its plain version: max err {err}, rel RMS {rel}")
                per_batch = C.epic_detection(**TP_RUNS[name]).num_layers
                require(res["val_launches"]["query_block_attention"]
                        == per_batch
                        and res["val_launches"]["fused_post_attention"] == 0,
                        f"tp-{name} rank {r}: validation launches "
                        f"{res['val_launches']}")
                require(res["train_launches"]["query_block_attention"] == 0,
                        f"tp-{name}: kernel 1 launched in training")
                require(min(res["collectives"]) > 0,
                        f"tp-{name}: no collective in a step")
                log(f"[tp-{name}] rank {r} ({card}; gloo on one card, "
                    f"not a tensor-parallel speed): step seconds "
                    f"{[round(x, 4) for x in res['step_s']]}, collectives "
                    f"per step {res['collectives']}; kernel 1 at "
                    f"{list(res['qba_shape'])} vs plain: max err {err:.3e}, "
                    f"rel RMS {rel:.3e}; validation launches "
                    f"{res['val_launches']}")
        # the fp32 slice: every loss and parameter within TP_SLICE_TOL
        got, want = ranks[0]["fp32-slice"], one["fp32-slice"]
        diff = tp_compare("tp-fp32-slice", got, want, TP_SLICE_TOL,
                          TP_SLICE_TOL)
        require(sorted(got["params"]) == sorted(want["params"]),
                "tp-fp32-slice: parameter names differ")
        worst, key_bias = 0.0, 0.0
        for k, w in want["params"].items():
            err = (got["params"][k] - w).abs()
            scale = max(w.abs().max().item(), 1e-30)
            if k.endswith("self_attn.in_proj_bias"):
                q, key, v = err.chunk(3)
                key_bias = max(key_bias, key.max().item() / scale)
                err = torch.cat([q, v])
            worst = max(worst, err.max().item() / scale)
        require(worst <= TP_SLICE_TOL and key_bias <= TP_KEY_BIAS_TOL,
                f"tp-fp32-slice: parameters within {worst} of each largest "
                f"value (tol {TP_SLICE_TOL}), key biases {key_bias} (tol "
                f"{TP_KEY_BIAS_TOL})")
        diff.update(params=worst, key_bias=key_bias)
        summary["fp32-slice"] = diff
        for name in ("bf16", "bf16-sp"):
            summary[name] = tp_compare(f"tp-{name}", ranks[0][name],
                                       one["bf16"], DET_VAL_PATHS_RTOL,
                                       TP_SCORE_TOL)
        controls = tp_score_controls(one["bf16"]["dump"])
        summary["score_controls"] = controls
        require(min(controls["shifted"], controls["reversed"])
                > TP_SCORE_TOL, f"tp: the score gate {TP_SCORE_TOL} passes "
                f"a faulty dump: {controls}")
        for name in TP_RUNS:
            for k in ("steps", "val", "dump"):
                a, b = ranks[0][name], ranks[1][name]
                require(a[k] == b[k] if k != "dump" else all(
                    np.array_equal(a[k][c], b[k][c]) for c in a[k]),
                    f"tp-{name}: ranks' {k} differ")
        # use_fused_ffn: kernel 2 on the gathered FFN weights
        sp = ranks[0]["bf16-sp"]
        fl = sp["fused_launches"]
        require(fl["fused_post_attention"] == 6
                and fl["query_block_attention"] == 6,
                f"tp-fused: validation launches {fl}")
        summary["fused"] = tp_compare(
            "tp-fused", {"steps": [], "val": sp["fused_val"],
                         "dump": sp["fused_dump"]},
            {"steps": [], "val": sp["val"], "dump": sp["dump"]},
            DET_VAL_PATHS_RTOL, TP_SCORE_TOL)
        # the ranks' checkpoint, strictly into one process
        payload = torch.load(tmp / "bf16-sp" / "checkpoint.pt",
                             map_location="cpu", weights_only=True)
        TimDetection(C.epic_detection(), device=TP_DEVICE).load_state_dict(
            payload["params"], strict=True)
        runner = DetectionRunner(
            C.epic_detection(), C.TrainConfig(batch_size=TP_BATCH, epochs=1,
                                              seed=SEED),
            None, splits[1], print_freq=1000, use_device_bank=True,
            device=TP_DEVICE)
        runner.load_torch_checkpoint(payload["params"])
        runner.state.normaliser = payload["normaliser"].to(TP_DEVICE)
        val, launches, dump, _ = tp_validate(runner)
        summary["checkpoint"] = tp_compare(
            "tp-checkpoint", {"steps": [], "val": val, "dump": dump},
            {"steps": [], "val": sp["val"], "dump": sp["dump"]},
            DET_VAL_PATHS_RTOL, TP_SCORE_TOL)
        del runner, one
        torch.cuda.empty_cache()
    dry = dryrun_multichip(1, device=TP_DEVICE)
    dry.pop("errors")
    summary["dryrun"] = dry
    log(f"[tp] {card}: every run within its gates; summary "
        f"{json.dumps(summary)}")
    for name in TP_RUNS:
        paths[f"tp-{name}-train"] = ranks[0][name]["train_launches"]
        paths[f"tp-{name}-val"] = ranks[0][name]["val_launches"]
    paths["tp-fused-val"] = sp["fused_launches"]
    return paths


# ---------------------------------------------------------------------------
# Phase 25: the JAX package's msgpack checkpoints on the card. The card's
# machine has no flax: each file is written by the port's encoder
# (``train.checkpoint.save_jax_checkpoint``, ``utils/msgpack.py``) and read
# back through the entry points, every route against the same state saved
# as ``checkpoint.pt``: (a) an EPIC detection ``DetectionRunner`` resumed
# and stepped, (b) ``--pretrained_model`` into bf16 and int8 serving, (c)
# recognition ``cli.run --validate --pretrained_model``, (d) (inside phase
# 22, which holds the pretraining state) a full-width MAE state into the
# finetune CLI's ``--pretrained``, (e) a faulty control. Phase 26, JAX's
# orbax directories (``train.checkpoint.save_checkpoint_orbax`` /
# ``load_checkpoint_orbax``), runs inside it as a third route beside the
# two, with the JAX-written fixture and two faults.
# ---------------------------------------------------------------------------
JAX_SERVE_SECONDS = 90.0   # the serving routes' cut of the 300 s video
JAX_ROUTES = ("pt", "jax", "orbax")   # .pt, msgpack, orbax directory
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "torch_orbax")
ORBAX_FLIP_KEY = "params.encoder.layer0.linear1.kernel/0.0"


def rate(nbytes, secs):
    return nbytes / max(secs, 1e-9) / 1e6


def det_state_diff(a, b):
    """The parts in which two detection train states differ: parameters,
    both moments, the four counters, step and normaliser (empty:
    bit-equal)."""
    bad = [f"param {n}" for (n, p), q in zip(a.model.state_dict().items(),
                                              b.model.state_dict().values())
           if not torch.equal(p, q)]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sorted(sa["state"]) != sorted(sb["state"]):
        bad.append("moment slots")
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            if i in sb["state"] and not torch.equal(sa["state"][i][k],
                                                    sb["state"][i][k]):
                bad.append(f"{k} {i}")
    bad += [f"counter {k}" for k in sa["if_finite"]
            if not torch.equal(sa["if_finite"][k], sb["if_finite"][k])]
    if a.step != b.step:
        bad.append("step")
    if not torch.equal(a.normaliser, b.normaliser):
        bad.append("normaliser")
    return bad


def payload_diff(got, want, path="payload"):
    """The leaves in which two checkpoint payloads differ (empty: the same
    keys, tensors of the same dtype, shape and bits, equal numbers)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path]
        return [d for k in want for d in payload_diff(got[k], want[k],
                                                      f"{path}/{k}")]
    if isinstance(want, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and torch.equal(got, want))
        return [] if ok else [path]
    return [] if type(got) is type(want) and got == want else [path]


def orbax_write_read(runner, tmp, extra, msgpack_payload):
    """26a, b: the runner's state as an orbax directory and back; its
    payload bit-equal to the msgpack file's."""
    from tim_tpu_torch.train import checkpoint as ckpt
    t0 = time.perf_counter()
    sizes = ckpt.save_checkpoint_orbax(str(tmp / "orbax"), runner.state,
                                       epoch=1, extra=extra)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = ckpt.load_checkpoint_orbax(str(tmp / "orbax"))
    read_s = time.perf_counter() - t0
    diff = payload_diff(payload, msgpack_payload)
    require(not diff, f"orbax: the payload differs from the msgpack "
            f"file's in {diff[:6]}")
    return {"orbax_bytes": sizes["total"], "orbax_value_bytes":
            sizes["values"], "orbax_write_s": write_s,
            "orbax_read_s": read_s,
            "orbax_write_mb_s": rate(sizes["total"], write_s),
            "orbax_read_mb_s": rate(sizes["total"], read_s)}


def jax_det_resume(train_ds, tmp, card):
    """25a, 25e and 26a, b: 2 banked steps of EPIC detection, saved as
    ``checkpoint.pt``, as ``checkpoint.msgpack`` and as an orbax
    directory; fresh runners resume each and take one more step: states
    and losses bit-equal. A copy of the msgpack file with ``mu`` and
    ``nu`` swapped in one leaf, resumed by the first runner, must differ
    from the .pt route in exactly those two moments."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.train import checkpoint as ckpt
    from tim_tpu_torch.utils import msgpack
    cfg = C.epic_detection()
    runner = det_runner(cfg, train_ds, None, True)
    batches = [runner._tables.batch(torch.arange(
        i * DET_BATCH, (i + 1) * DET_BATCH, device="cuda")) for i in range(3)]
    for batch in batches[:2]:
        runner._bank_step(runner.state, batch)
    torch.cuda.synchronize()
    extra = {"val_stats": {"loss": 1.5, "top1": 37.5}}
    t0 = time.perf_counter()
    ckpt.save_checkpoint(str(tmp / "pt"), runner.state, epoch=1, extra=extra)
    pt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbytes = ckpt.save_jax_checkpoint(str(tmp / "jax"), runner.state,
                                      epoch=1, extra=extra)
    write_s = time.perf_counter() - t0
    fname = str(tmp / "jax" / "checkpoint.msgpack")
    t0 = time.perf_counter()
    payload = msgpack.load(fname)
    read_s = time.perf_counter() - t0
    require(os.path.getsize(fname) == nbytes
            and int(payload["step"]) == 2 and int(payload["epoch"]) == 1,
            "jax-ckpt: the msgpack payload's size, step or epoch")
    orbax = timed("orbax-write-read", orbax_write_read, runner, tmp, extra,
                  payload)
    fresh = {}
    for route in JAX_ROUTES:
        fresh[route] = det_runner(cfg, train_ds, None, True)
        t0 = time.perf_counter()
        epoch = fresh[route].resume(str(tmp / route))
        secs = time.perf_counter() - t0
        require(epoch == 1, f"jax-ckpt-{route}: epoch {epoch}")
        fresh[f"{route}_s"] = secs
    same = det_state_diff(fresh["pt"].state, fresh["jax"].state)
    same += det_state_diff(fresh["pt"].state, fresh["orbax"].state)
    same += det_state_diff(fresh["pt"].state, runner.state)
    require(not same, f"jax-ckpt: resumed states differ: {same[:6]}")

    # 25e: the file with mu and nu swapped in one leaf fails that check
    adam = payload["opt_state"]["inner_state"]["1"]["0"]
    mu, nu = (adam[m]["encoder"]["layer0"]["linear1"] for m in ("mu", "nu"))
    mu["kernel"], nu["kernel"] = nu["kernel"], mu["kernel"]
    os.makedirs(tmp / "control")
    with open(tmp / "control" / "checkpoint.msgpack", "wb") as f:
        f.write(msgpack.msgpack_serialize(payload))
    del payload
    runner.resume(str(tmp / "control"))
    rejected = det_state_diff(fresh["pt"].state, runner.state)
    require(len(rejected) == 2, f"jax-ckpt-control: the state resumed from "
            f"swapped moments differs in {rejected[:6]}, expected the two "
            f"moments of one parameter")

    losses = {}
    for route in JAX_ROUTES:
        r = fresh[route]
        losses[route] = r._bank_step(r.state, batches[2])["loss"]
    for route in JAX_ROUTES[1:]:
        after = det_state_diff(fresh["pt"].state, fresh[route].state)
        require(not after and torch.equal(losses["pt"], losses[route]),
                f"jax-ckpt-{route}: one step after the resume differs: "
                f"{after[:6]}, loss {float(losses['pt'])} vs "
                f"{float(losses[route])}")
    log(f"[jax-ckpt] {card}: EPIC detection state after 2 banked bf16 "
        f"steps of {DET_BATCH}: checkpoint.msgpack {nbytes} bytes, written in "
        f"{write_s:.3f} s ({rate(nbytes, write_s):.1f} MB/s, gather + "
        f"convert + encode + write; checkpoint.pt {pt_s:.3f} s), decoded in "
        f"{read_s:.3f} s ({rate(nbytes, read_s):.1f} MB/s), resumed in "
        f"{fresh['jax_s']:.3f} s (checkpoint.pt {fresh['pt_s']:.3f} s); "
        f"parameters, moments, counters, step, normaliser and epoch "
        f"bit-equal to the .pt route, after one more step too (loss "
        f"{float(losses['jax']):.6f}); the swapped-moments control differs "
        f"in {len(rejected)} parts ({rejected[:2]})")
    log(f"[orbax-ckpt] {card}: the same state as orbax/1 (OCDBT, zarr, "
        f"zstd level 1): {orbax['orbax_bytes']} bytes "
        f"({orbax['orbax_value_bytes']} of chunks in the data file), "
        f"written in {orbax['orbax_write_s']:.3f} s "
        f"({orbax['orbax_write_mb_s']:.1f} MB/s, gather + convert + "
        f"compress + write), read in {orbax['orbax_read_s']:.3f} s "
        f"({orbax['orbax_read_mb_s']:.1f} MB/s), its payload bit-equal to "
        f"the msgpack file's; resumed in {fresh['orbax_s']:.3f} s "
        f"(load_checkpoint's fallback to orbax/1): the state and the next "
        f"step bit-equal to the .pt and msgpack routes (loss "
        f"{float(losses['orbax']):.6f})")
    del runner, fresh
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "write_s": write_s, "read_s": read_s,
            "write_mb_s": rate(nbytes, write_s),
            "read_mb_s": rate(nbytes, read_s), "pt_write_s": pt_s,
            **orbax}


def jax_det_serve(train_ds, tmp, video, batch2):
    """25b and 26c: ``init_state(pretrained=...)``
    (``--pretrained_model``) from the .pt, the msgpack and the orbax
    directories, each model's weights served by bf16 ``detect_video``
    (kernels 1 and 2) and by ``DetectionServer.quantized`` (kernel 3)
    over a cut of the video: detections bit-equal between the routes."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.runner.detection import DetectionRunner
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step
    v, a, feat_times, _ = video
    n = int(JAX_SERVE_SECONDS / 0.2)
    cut = (v[:n], a[:n], feat_times[:n], JAX_SERVE_SECONDS)
    tcfg = C.TrainConfig(batch_size=DET_BATCH, epochs=1, seed=SEED)
    cfg16 = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True)
    cfg8 = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True,
                            quant_pallas_heads=True)
    dets, paths, threshold = {}, {}, None
    for route in JAX_ROUTES:
        runner = DetectionRunner(C.epic_detection(), tcfg, train_ds, None,
                                 print_freq=1000, device="cuda")
        runner.init_state(pretrained=str(tmp / route))
        sd = runner.model.state_dict()
        del runner
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                server = DetectionServer(cfg16, sd, device="cuda",
                                         batch_size=128, top_k=8)
                if threshold is None:
                    # as phase 5 reads it off: the score that about
                    # TARGET_CANDIDATES candidates over the cut would clear
                    # if every window scored like batch2's
                    scores = make_inference_step(server.model, cfg16)(
                        to_torch(batch2, "cuda"))["v_scores"]
                    top = torch.sort(scores.flatten(), descending=True).values
                    n_windows = len(server._window_starts(cut[3]))
                    threshold = top[int(TARGET_CANDIDATES / n_windows
                                        * len(batch2["times"]))].item()
            else:
                server = DetectionServer.quantized(
                    cfg8, sd, [to_torch(batch2, "cuda")], device="cuda",
                    batch_size=128, top_k=8)
            counters = zero_counts()
            dets[route, kind] = server.detect_video(
                *cut, score_threshold=threshold)
            paths[f"jax-serve-{kind}", route] = read_counts(counters)
            del server
        del sd
    for kind in ("bf16", "int8"):
        for route in JAX_ROUTES[1:]:
            got, want = dets[route, kind], dets["pt", kind]
            require(sorted(got) == sorted(want) and all(
                np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                for k in want) and len(want["scores"]) > 0,
                f"jax-serve-{kind}-{route}: detections differ from the .pt "
                f"route's")
            require(paths[f"jax-serve-{kind}", route]
                    == paths[f"jax-serve-{kind}", "pt"],
                    f"jax-serve-{kind}-{route}: launches differ between the "
                    f"routes")
    l16, l8 = paths["jax-serve-bf16", "jax"], paths["jax-serve-int8", "jax"]
    require(l16["query_block_attention"] > 0 and l16["fused_post_attention"]
            > 0 and l8["int8_matmul_fused"] > 0,
            f"jax-serve: launches bf16 {l16}, int8 {l8}")
    log(f"[jax-ckpt-serve] --pretrained_model from checkpoint.msgpack: bf16 "
        f"detect_video over {JAX_SERVE_SECONDS:.0f} s "
        f"({len(dets['jax', 'bf16']['scores'])} detections) and int8 "
        f"({len(dets['jax', 'int8']['scores'])}) bit-equal to the .pt "
        f"route (score threshold {threshold:.6f}); launches bf16 {l16}, int8 "
        f"{l8}; the same from the orbax directory, bit-equal too")
    torch.cuda.empty_cache()
    return {"jax-serve-bf16": l16, "jax-serve-int8": l8,
            "orbax-serve-bf16": paths["jax-serve-bf16", "orbax"],
            "orbax-serve-int8": paths["jax-serve-int8", "orbax"]}


def jax_rec_validate(val_ds, state_dict, tmp):
    """25c: phase 17's trained recognition weights in a train state saved
    as .pt and as msgpack; ``cli.run --validate --pretrained_model`` on
    each (kernel 1): statistics bit-equal."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    from tim_tpu_torch.train import checkpoint as ckpt
    args = cli_args("recognition", tmp / "rec", "--validate")
    mcfg, tcfg = cli.configs_from_args(args)
    runner = RecognitionRunner(mcfg, tcfg, None, val_ds, print_freq=1000,
                               use_device_bank=True, device="cuda")
    runner.load_torch_checkpoint(state_dict)
    ckpt.save_checkpoint(str(tmp / "rec_pt"), runner.state, epoch=1)
    nbytes = ckpt.save_jax_checkpoint(str(tmp / "rec_jax"), runner.state,
                                      epoch=1)
    del runner
    stats, launches = {}, {}
    for route in ("pt", "jax"):
        args = cli_args("recognition", tmp / f"rec_out_{route}", "--validate",
                        "--pretrained_model", str(tmp / f"rec_{route}"))
        stats[route], launches[route], _ = cli_run(
            f"jax-cli-rec-val-{route}", args, None, val_ds)
    batches = -(-len(val_ds) // REC_BATCH)
    require_kernel1("jax-cli-rec-val", launches["jax"], mcfg.num_layers,
                    batches)
    require(stats["jax"] == stats["pt"] and launches["jax"] == launches["pt"],
            f"jax-cli-rec-val: {stats['jax']} vs the .pt route's "
            f"{stats['pt']}")
    log(f"[jax-ckpt-rec] cli.run --validate --pretrained_model "
        f"checkpoint.msgpack ({nbytes} bytes): statistics bit-equal to the "
        f".pt route's {json.dumps(stats['jax'])}")
    torch.cuda.empty_cache()
    return {"jax-cli-rec-val": launches["jax"]}


def orbax_fixture(card):
    """26d: the JAX-written fixture: its orbax payload (tensorstore's zstd
    frames, decoded by libzstd here) bit-equal to its msgpack twin; a
    small ``TimDetection`` on the card loaded strictly from each, state
    dicts bit-equal."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models.tim import TimDetection
    from tim_tpu_torch.train import checkpoint as ckpt
    from tim_tpu_torch.utils import ocdbt
    with open(os.path.join(ORBAX_FIXTURE, "config.json")) as f:
        cfg = C.DetectionConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in json.load(f).items()})
    t0 = time.perf_counter()
    payloads = {"orbax": ckpt.load_checkpoint_orbax(ORBAX_FIXTURE),
                "msgpack": ckpt.load_checkpoint(ORBAX_FIXTURE)}
    read_s = time.perf_counter() - t0
    diff = payload_diff(payloads["orbax"], payloads["msgpack"])
    require(not diff, f"orbax-fixture: the payload differs from its msgpack "
            f"twin in {diff[:6]}")
    states = {}
    for route, payload in payloads.items():
        model = TimDetection(cfg, device="cuda")
        sd, kept = ckpt.jax_merge(model, payload["params"])
        require(not kept, f"orbax-fixture-{route}: not in the file: "
                f"{kept[:4]}")
        model.load_state_dict(sd, strict=True)
        states[route] = model.state_dict()
    bad = [n for n, t in states["msgpack"].items()
           if not (t.is_cuda and torch.equal(states["orbax"][n], t))]
    require(not bad, f"orbax-fixture: the card's models differ in {bad[:6]}")
    values = ocdbt.read_store(os.path.join(ORBAX_FIXTURE, "orbax", "1"))
    frames = sum(not k.endswith(".zarray") for k in values)
    log(f"[orbax-fixture] {card}: the JAX-written tests/data/torch_orbax "
        f"({frames} zstd chunk frames, {len(states['orbax'])} state dict "
        f"entries) read in {read_s:.3f} s with its msgpack twin: payloads "
        f"bit-equal, loaded strictly into TimDetection on the card from "
        f"both, bit-equal")
    return {"frames": frames, "read_s": read_s}


def orbax_controls(tmp):
    """26e: faults in the EPIC orbax directory: a flipped byte in one chunk
    (then put back), then its data file cut short by one byte: each load
    raises ``ValueError`` naming the key."""
    from tim_tpu_torch.train import checkpoint as ckpt
    from tim_tpu_torch.utils import ocdbt
    step = os.path.join(str(tmp / "orbax"), "orbax", "1")
    where = {}
    ocdbt.read_store(step, locations=where)

    def rejected(tag, key):
        try:
            ckpt.load_checkpoint(str(tmp / "orbax"))
        except ValueError as e:
            require(key in str(e), f"orbax-control-{tag}: {e} names not "
                    f"{key}")
            return str(e)
        require(False, f"orbax-control-{tag}: the faulty directory loaded")

    rel, offset, length = where[ORBAX_FLIP_KEY]
    fname = os.path.join(step, rel)
    with open(fname, "r+b") as f:
        f.seek(offset + length // 2)
        byte = f.read(1)[0]
        f.seek(offset + length // 2)
        f.write(bytes([byte ^ 0x01]))
    flip = rejected("flip", ORBAX_FLIP_KEY)
    with open(fname, "r+b") as f:
        f.seek(offset + length // 2)
        f.write(bytes([byte]))
    last, (rel, offset, length) = max(where.items(), key=lambda kv: kv[1][1])
    with open(os.path.join(step, rel), "r+b") as f:
        f.truncate(offset + length - 1)
    cut = rejected("truncate", last)
    log(f"[orbax-controls] a flipped byte in {ORBAX_FLIP_KEY}: {flip}; the "
        f"data file one byte short: {cut}")
    return {"flip": flip, "truncate": cut}


def phase_jax_checkpoints(det_splits, rec_val_ds, rec_state_dict, video,
                          batch2, card):
    """Phase 25 (a, b, c, e) with phase 26; returns the launches of its
    paths."""
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        summary = {"resume": timed("jax-ckpt-resume", jax_det_resume,
                                   det_splits[0], tmp, card)}
        paths = timed("jax-ckpt-serve", jax_det_serve, det_splits[0], tmp,
                      video, batch2)
        paths.update(timed("jax-ckpt-rec", jax_rec_validate, rec_val_ds,
                           rec_state_dict, tmp))
        summary["orbax_fixture"] = timed("orbax-fixture", orbax_fixture,
                                         card)
        timed("orbax-controls", orbax_controls, tmp)
    log(f"[jax-ckpt] summary {json.dumps(summary)}")
    return paths


def usable_cpus() -> int:
    """CPUs this process may use: its affinity, capped by the cgroup v2
    quota when one is set (a container may see more CPUs than it may
    use)."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            n = min(n, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return n


def phase_build():
    """Phase 2: the library built from ``tim_tpu_torch/csrc``; logs each
    source's compile seconds and, per attention, tail and int8 kernel, the
    registers and spill bytes ``ptxas`` reported."""
    from tim_tpu_torch import _build
    lib = _build.build()
    _build.library()
    sources, kernels = _build.resource_usage(lib)
    log(f"[build] compile seconds per source: {', '.join(sources)}")
    names = [k[0] for k in kernels]
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt")
    pretty = names
    if os.path.exists(tool):
        filt = subprocess.run([tool], input="\n".join(names),
                              capture_output=True, text=True, timeout=60)
        if len(filt.stdout.splitlines()) == len(names):
            pretty = filt.stdout.splitlines()
    for (name, regs, st, ld), nice in zip(kernels, pretty):
        if any(ns in name for ns in ("tim_attn", "tim_qba", "tim_fpa",
                                     "tim_i8")):
            log(f"[build] ptxas: {nice}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")
    # the wgmma kernels (by namespace and name, mangled or not) spill
    # nothing, and ptxas serialised none of their products (its warnings
    # C7510-C7520)
    wgmma = (("fwd90", "attention_kernel"), ("sm90", "bwd_kernel"),
             ("bwd90", "dkdv_kernel"), ("bwd90", "dq_kernel"),
             ("cols90", "cols_kernel"), ("colsbwd90", "bwd_kernel"),
             ("tim_fpa", "gemm_kernel"),
             ("tim_i8", "int8_matmul_kernel"))
    spilled = [nice for (name, regs, st, ld), nice in zip(kernels, pretty)
               if any(a in name and b in name for a, b in wgmma)
               and (st or ld)]
    with open(f"{lib}.log") as f:
        serial = sorted(set(re.findall(r"[^\n]*C75[12]\d[^\n]*", f.read())))
    log(f"[build] ptxas wgmma serialisation warnings: "
        f"{serial if serial else 'none'}; wgmma kernels that spill: "
        f"{spilled if spilled else 'none'}")
    require(not serial and not spilled, "a wgmma kernel spills or has its "
            "products serialised")
    return lib


# ---------------------------------------------------------------------------
# Phase 31: the widths the command lines take
# ---------------------------------------------------------------------------

# The wide TIM (cli --d_model 1280 --nhead 16: C 2560, head dim 160, FF
# 5120), an odd-width TIM (--d_model 364 --nhead 8: C 728, head dim 91, FF
# 1456) and VideoMAE ViT-H/16 (finetune_cli --embed_dim 1280 --depth 32
# --num_heads 16: head dim 80)
WIDE_TIM = {"d_model": 1280, "nhead": 16}
ODD_TIM = {"d_model": 364, "nhead": 8}
VIT_H = ("--embed_dim", "1280", "--depth", "32", "--num_heads", "16")
# kernel 5 / 5b at the VideoMAE head dims past 64 (ViT-H/16's 80, ViT-g/14's
# 88 and ViT-G/14's 104, read in place by the bf16 instances 80, 96 and
# 112; 128 on its own instance) and at 91 (no multiple of 8: the
# zero-padded copy); the batch-8 shapes are timed
WIDTH_FLASH = ((8, 16, 1568, 80), (8, 16, 1568, 88), (2, 16, 1568, 104),
               (8, 16, 1568, 128), (2, 16, 1568, 91))


def packed_views(batch, seq, heads, dh, dtype, gen, f=None):
    """q/k/v of one layer as strided views of a packed [B, S, 3, H, dh]
    projection: the ViT's [B, H, S, dh] triple, or (``f``: TIM's F context
    tokens first) kernel 1's five views."""
    qkv = torch.randn(batch, seq, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if f is None:
        return q, k, v
    return (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])


def launches_of(counter, call) -> int:
    """The launches ``counter`` (a wrapper with a ``launches`` count)
    records during one ``call()``."""
    before = counter.launches
    call()
    return counter.launches - before


def routes_by_name(fn, call):
    """The route counts (``fn.routes``) that one ``call()`` adds."""
    before = collections.Counter(fn.routes)
    call()
    torch.cuda.synchronize()
    return dict(fn.routes - before)


def routes_of(call):
    """The (forward, backward) route counts of kernels 5 / 5b
    (``flash_mha.routes``) that one ``call()`` adds."""
    from tim_tpu_torch.ops import flash_mha as fm
    before = (collections.Counter(fm.flash_mha.routes),
              collections.Counter(fm.flash_mha_bwd.routes))
    call()
    torch.cuda.synchronize()
    return (dict(fm.flash_mha.routes - before[0]),
            dict(fm.flash_mha_bwd.routes - before[1]))


def widths_flash_routes(tag, q, k, v, out, lse, do, kw):
    """The bf16 routes of one shape: one forward, one backward and one
    autograd step on the packed projection each launch the plan's
    instance, with no copy where the head dim is a multiple of 8; the
    backward's two calls under ``torch.use_deterministic_algorithms``
    bit-equal to each other and to the default route's. Returns the
    routes."""
    from tim_tpu_torch.ops import flash_mha as fm
    dh = q.shape[-1]
    w, copied = fm.launch_plan(dh, q.dtype, q, k, v)
    require(copied == (dh % 8 != 0), f"widths {tag}: plan {w}, copied "
            f"{copied}")
    want_f = {fm.route(q.dtype, w, copied): 1}
    want_b = {fm.route(q.dtype, w, copied, backward=True): 1}
    got_f, _ = routes_of(lambda: fm.flash_mha(q, k, v, **kw))
    _, got_b = routes_of(lambda: fm.flash_mha_bwd(q, k, v, out, lse, do,
                                                  **kw))
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2)
    leaf = qkv.detach().requires_grad_()
    step_f, step_b = routes_of(lambda: (fm.flash_mha_qkv(
        leaf, **kw).float() * do.float()).sum().backward())
    log(f"[widths] flash_mha {tag} routes: forward {got_f}, backward "
        f"{got_b}, autograd step {step_f} + {step_b} (plan: instance {w}, "
        f"{'copied' if copied else 'read in place'})")
    require(got_f == want_f and got_b == want_b and step_f == want_f
            and step_b == want_b, f"widths {tag}: routes {got_f}, {got_b}, "
            f"{step_f}, {step_b}; expected {want_f}, {want_b}")
    default = [g.clone() for g in fm.flash_mha_bwd(q, k, v, out, lse, do,
                                                   **kw)]
    torch.use_deterministic_algorithms(True)
    try:
        first = [g.clone() for g in fm.flash_mha_bwd(q, k, v, out, lse, do,
                                                     **kw)]
        second = fm.flash_mha_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    as_default = [torch.equal(a, b) for a, b in zip(first, default)]
    log(f"[widths] flash_mha_bwd {tag} deterministic route: two calls "
        f"bit-equal (dq, dk, dv) {same}, equal to the default route "
        f"{as_default}")
    require(all(same) and all(as_default), f"widths {tag}: the backward is "
            f"not bit-stable: {same}, {as_default}")
    return {"forward": got_f, "backward": got_b}


def sdpa_backend(*args, **kwargs) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    arguments (its dispatcher's choice, ``torch.nn.attention.SDPBackend``)."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name
    except Exception as e:  # noqa: BLE001 (a torch without the dispatcher)
        return f"unknown ({type(e).__name__})"


def widths_flash(gen, shapes=None, f32_batch=None, time_all=False):
    """Kernels 5 and 5b at the VideoMAE head dims past 64 (bf16 on the
    instances that read them in place) and at 91 (the zero-padded copy),
    or at ``shapes`` (fp32 at batch ``f32_batch`` where given), fp32 and
    bf16, against their plain versions under the gates in force, the bf16
    gates shown to reject their faulty controls; in bf16 the routes each
    call takes and the backward's bit-stability; the batch-8 shapes (every
    bf16 shape with ``time_all``) timed beside SDPA (the backward's
    deterministic route too), SDPA's backend named."""
    from tim_tpu_torch.ops import flash_mha as fm
    rows_f, rows_b = [], []
    for b0, h, s, dh in shapes or WIDTH_FLASH:
        scale = dh ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            b = b0 if bf16 or not f32_batch else f32_batch
            w, copied = fm.launch_plan(dh, dtype)
            tag = (f"{dtype} [{b}, {h}, {s}, {dh}] (instance {w}, "
                   f"{'copied' if copied else 'in place'})")
            q, k, v = packed_views(b, s, h, dh, dtype, gen)
            kw = {"sm_scale": scale}
            got, err = check_attention("flash_mha", fm.flash_mha,
                                       fm.flash_mha_plain, vit_scores,
                                       (q, k, v), kw, f"widths {tag}",
                                       controls=bf16)
            out, lse = fm.flash_mha_with_lse(q, k, v, **kw)
            do = torch.randn(out.shape, generator=gen,
                             device="cuda").to(dtype)
            grads = fm.flash_mha_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            want = fm.flash_mha_bwd_plain(q, k, v, do, **kw)
            gerr = check_grads("flash_mha_bwd", grads, want, bf16,
                               f"widths {tag}")
            routes = None
            if bf16:
                sc = vit_scores(q, k, v, **kw)
                bad = emulated_attention_bwd(sc, q, k, v, do, drop_delta=True,
                                             **kw)
                check_controls("flash_mha_bwd", f"widths {tag}", want,
                               [("D omitted, dq", 0, bad[0]),
                                ("D omitted, dk", 1, bad[1])])
                del sc, bad
                routes = widths_flash_routes(tag, q, k, v, out, lse, do, kw)
            del got, grads, want
            torch.cuda.empty_cache()
            if not bf16 or (b != 8 and not time_all):
                rows_f.append({"shape": [b, h, s, dh], "dtype": str(dtype),
                               "instance": w, "copied": copied,
                               "max_abs_err": err})
                rows_b.append({"shape": [b, h, s, dh], "dtype": str(dtype),
                               "instance": w, "copied": copied,
                               "max_abs_err": gerr, "routes": routes})
                del q, k, v, out, lse, do
                continue
            n_scores = b * h * s * s
            nb = nbytes(q, k, v, out)
            row = time_forward(fm.flash_mha, fm.flash_mha_with_lse,
                               fm.flash_mha_plain,
                               lambda: F.scaled_dot_product_attention(
                                   q, k, v, scale=scale),
                               sdpa_with_grad(q, k, v, scale=scale),
                               (q, k, v), kw, nb, n_scores, dh)
            row.update(shape=[b, h, s, dh], dtype=str(dtype),
                       max_abs_err=err, instance=w, copied=copied,
                       routes=routes["forward"], library=sdpa_backend(
                           q, k, v, scale=scale),
                       launches=launches_of(fm.flash_mha, lambda: fm.flash_mha(
                           q, k, v, **kw)))
            lib_err = max_err(F.scaled_dot_product_attention(
                q, k, v, scale=scale), fm.flash_mha(q, k, v, **kw))
            log_forward("flash_mha", f"widths [{b}, {h}, {s}, {dh}]", row,
                        "scaled_dot_product_attention", lib_err)
            log(f"[widths] flash_mha [{b}, {h}, {s}, {dh}] bf16: instance "
                f"{w}, {'copied' if copied else 'read in place'}; "
                f"{row['launches']} launch a call; kernel / SDPA "
                f"{row['ms'] / row['library_ms']:.3f} (SDPA's backend "
                f"{row['library']})")
            rows_f.append(row)
            brow = {"shape": [b, h, s, dh], "dtype": str(dtype),
                    "max_abs_err": gerr, "instance": w, "copied": copied,
                    "routes": routes["backward"],
                    "launches": launches_of(
                        fm.flash_mha_bwd, lambda: fm.flash_mha_bwd(
                            q, k, v, out, lse, do, **kw))}
            brow["ms"] = cuda_ms(lambda: fm.flash_mha_bwd(
                q, k, v, out, lse, do, **kw))
            torch.use_deterministic_algorithms(True)
            try:
                brow["deterministic_ms"] = cuda_ms(lambda: fm.flash_mha_bwd(
                    q, k, v, out, lse, do, **kw))
            finally:
                torch.use_deterministic_algorithms(False)
            brow["plain_ms"] = cuda_ms(lambda: fm.flash_mha_bwd_plain(
                q, k, v, do, **kw), iters=3, warmup=1)
            brow["library_ms"] = sdpa_bwd_ms(q, k, v, do)
            brow["library"] = row["library"]
            brow["bound_ms"], brow["bound_by"] = attention_bwd_bound(
                q, 2 * nbytes(q, k, v) + nbytes(out, do, lse))
            brow["share_of_bound"] = brow["bound_ms"] / brow["ms"]
            log(f"[widths] flash_mha_bwd [{b}, {h}, {s}, {dh}] bf16 "
                f"({routes['backward']}): kernel {brow['ms']:.4f} ms "
                f"({brow['launches']} launch a call), deterministic route "
                f"{brow['deterministic_ms']:.4f} ms, plain "
                f"{brow['plain_ms']:.4f} ms, scaled_dot_product_attention "
                f"backward {brow['library_ms']:.4f} ms (kernel / SDPA "
                f"{brow['ms'] / brow['library_ms']:.3f}), bound "
                f"{brow['bound_ms']:.4f} ms ({brow['bound_by']}, "
                f"{100 * brow['share_of_bound']:.1f}%)")
            rows_b.append(brow)
            del q, k, v, out, lse, do
            torch.cuda.empty_cache()
    return {"flash_mha": rows_f, "flash_mha_bwd": rows_b}


def widths_query_block(gen, shapes=((128, 16, 160), (128, 8, 91)),
                       f32_batch=None):
    """Kernel 1 at the wide TIM's [128, 16, 798, 160] (F 100; bf16 on the
    tensor-core instance at 160) and at head dim 91 on strided views of a
    packed qkv (rows off 16 bytes: the CUDA-core design, lanes masked), or
    at ``shapes`` ((batch, heads, head dim); fp32 at batch ``f32_batch``
    where given), fp32 and bf16, bf16's gate shown to reject its two
    controls; bf16 timed beside masked SDPA, its backend named."""
    from tim_tpu_torch.ops import query_block_attention as qba
    rows = []
    for batch0, heads, dh in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            batch = batch0 if dtype == torch.bfloat16 or not f32_batch \
                else f32_batch
            args = packed_views(batch, 898, heads, dh, dtype, gen, f=100)
            plan = qba.launch_plan(dh, dtype, *args)
            tag = f"{dtype} [{batch}, {heads}, 798, {dh}] F 100 ({plan})"
            got = qba.query_block_attention(*args)
            torch.cuda.synchronize()
            want = qba.query_block_attention_plain(*args)
            ok, err, rel = query_block_close(got, want)
            log(f"[widths] query_block_attention {tag}: max_abs_err="
                f"{err:.3e}, relative RMS {rel:.3e}")
            require(got.shape == want.shape and ok,
                    f"query_block_attention {tag} disagrees with its plain "
                    f"version: max abs {err}, relative RMS {rel}")
            row = {"shape": [batch, heads, 798, dh], "f": 100,
                   "dtype": str(dtype), "plan": plan, "max_abs_err": err,
                   "route": routes_by_name(qba.query_block_attention,
                                           lambda: qba.query_block_attention(
                                               *args))}
            if dtype == torch.bfloat16:
                for cname, bad in (("self term dropped",
                                    query_block_without_self(*args)),
                                   ("output x 0.98",
                                    (want.float() * 0.98).to(want.dtype))):
                    c_ok, c_err, c_rel = query_block_close(bad, want)
                    log(f"[widths] query_block_attention {tag} control "
                        f"'{cname}': max abs {c_err:.3e}, relative RMS "
                        f"{c_rel:.3e}, {'passes' if c_ok else 'rejected'}")
                    require(not c_ok, f"query_block_attention {tag}: the "
                            f"bf16 gate passes the faulty control '{cname}'")
                    del bad
                qq, kc = args[0], args[1]
                ops = 4 * batch * heads * 798 * 101 * dh
                row["ms"] = cuda_ms(lambda: qba.query_block_attention(*args))
                row["plain_ms"] = cuda_ms(
                    lambda: qba.query_block_attention_plain(*args), iters=3)
                sdpa = masked_sdpa_args(*args)
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
                row["library"] = sdpa_backend(sdpa[0], sdpa[1], sdpa[2],
                                              attn_mask=sdpa[3])
                del sdpa
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(*args) + nbytes(got), ops, "bf16")
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                row["launches"] = launches_of(
                    qba.query_block_attention,
                    lambda: qba.query_block_attention(*args))
                log(f"[widths] query_block_attention {tag}: kernel "
                    f"{row['ms']:.4f} ms ({row['launches']} launch a call, "
                    f"route {row['route']}), plain {row['plain_ms']:.4f} ms, "
                    f"masked scaled_dot_product_attention "
                    f"{row['library_ms']:.4f} ms ({row['library']}), bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                    f"{100 * row['share_of_bound']:.1f}%)")
            rows.append(row)
            del args, got, want
            torch.cuda.empty_cache()
    return rows


def widths_tail(gen):
    """Kernel 2 at the wide TIM's C 2560 / FF 5120 and the odd TIM's C 728
    / FF 1456 (bf16 at batch 128, fp32 at 16; S 898): the presets' checks
    and controls, bf16 timed beside the unfused library-GEMM tail."""
    from tim_tpu_torch.ops import fused_post_attention as fpa
    rows = []
    for c, ff in ((2560, 5120), (728, 1456)):
        for dtype, batch in ((torch.bfloat16, 128), (torch.float32, 16)):
            args = tail_args(batch, dtype, gen, c=c, ff=ff)
            tag = f"{dtype} [{batch} x 898, {c}] FF {ff}"
            got = fpa.fused_post_attention(*args)
            torch.cuda.synchronize()
            want = fpa.fused_post_attention_plain(*args)
            ok, err, rel = fused_close(got, want)
            log(f"[widths] fused_post_attention {tag}: max_abs_err="
                f"{err:.3e}, relative RMS {rel:.3e}")
            require(got.shape == want.shape and ok,
                    f"fused_post_attention {tag} disagrees with its plain "
                    f"version: max abs {err}, relative RMS {rel}")
            row = {"shape": [batch * 898, c, ff], "dtype": str(dtype),
                   "max_abs_err": err, "relative_rms": rel,
                   "plan": list(fpa.launch_plan(c, ff, dtype))}
            if dtype == torch.bfloat16:
                no_b2 = list(args)
                no_b2[7] = torch.zeros_like(args[7])
                controls = (("b2 omitted",
                             fpa.fused_post_attention_plain(*no_b2)),
                            ("LN2 statistics over half the row",
                             tail_with_ln2_over_half(*args)))
                for cname, bad in controls:
                    c_ok, c_err, c_rel = fused_close(bad, want)
                    log(f"[widths] fused_post_attention {tag} control "
                        f"'{cname}': max abs {c_err:.3e}, relative RMS "
                        f"{c_rel:.3e}, {'passes' if c_ok else 'rejected'}")
                    require(not c_ok, f"fused_post_attention {tag}: the "
                            f"bf16 gate passes the faulty control '{cname}'")
                del controls, bad, no_b2, want
                torch.cuda.empty_cache()
                n = batch * 898
                row["ms"] = cuda_ms(lambda: fpa.fused_post_attention(*args))
                row["plain_ms"] = cuda_ms(
                    lambda: fpa.fused_post_attention_plain(*args), iters=2,
                    warmup=1)
                row["library_ms"] = cuda_ms(lambda: unfused_tail(*args))
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(*args) + nbytes(got), 4 * n * c * ff, "bf16")
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                row["launches"] = launches_of(
                    fpa.fused_post_attention,
                    lambda: fpa.fused_post_attention(*args))
                log(f"[widths] fused_post_attention {tag}: kernel "
                    f"{row['ms']:.4f} ms ({row['launches']} launch a call), "
                    f"plain {row['plain_ms']:.4f} ms, "
                    f"unfused library-GEMM tail {row['library_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                    f"{100 * row['share_of_bound']:.1f}%)")
            rows.append(row)
            del args, got
            torch.cuda.empty_cache()
    return rows


def widths_int8(gen):
    """Kernel 3 at the wide TIM's fc_action (K 2560: two chunks through the
    tile) and at K 728 (w_q padded once to 736), plus K 726 (x's rows off
    16 bytes) and fp32 inputs at a small batch: the plain version's int8
    gate and a control without the bias; bf16 timed beside the library
    route (quantize + _int_mm + epilogue)."""
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    rows = []
    for k, batch, dtype, timed_ in ((2560, 128, torch.bfloat16, True),
                                    (728, 128, torch.bfloat16, True),
                                    (2560, 4, torch.float32, False),
                                    (726, 4, torch.bfloat16, False),
                                    (726, 4, torch.float32, False)):
        n = 3806
        x, w_q, w_scale, sx, b = int8_head_args(batch, n, dtype, gen, k=k)
        w_k = i8.pad_weight(w_q)
        tag = (f"{dtype} [{x.shape[0] * x.shape[1]} x {k}] -> {n} "
               f"(plan {i8.launch_plan(k)})")
        got = i8.int8_matmul_fused(x, w_k, w_scale, sx, b)
        got_unpadded = i8.int8_matmul_fused(x, w_q, w_scale, sx, b)
        torch.cuda.synchronize()
        want = i8.int8_matmul_fused_plain(x, w_q, w_scale, sx, b)
        err = max_err(got, want)
        log(f"[widths] int8_matmul_fused {tag}: max_abs_err={err:.3e}")
        require(int8_close(got, want) and torch.equal(got, got_unpadded),
                f"int8_matmul_fused {tag} disagrees with its plain version "
                f"(max abs {err}) or with its unpadded-weight call")
        bad = i8.int8_matmul_fused_plain(x, w_q, w_scale, sx, None)
        require(not int8_close(bad, want), f"int8_matmul_fused {tag}: the "
                f"gate passes the control without the bias")
        del bad, got_unpadded
        row = {"m": x.shape[0] * x.shape[1], "k": k, "n": n,
               "dtype": str(dtype), "max_abs_err": err,
               "launches_per_call": i8.launch_plan(k)[0]}
        if timed_:
            m = row["m"]
            w_pad = F.pad(w_q, (0, 0, 0, -n % 8))
            row["ms"] = cuda_ms(lambda: i8.int8_matmul_fused(
                x, w_k, w_scale, sx, b))
            row["plain_ms"] = cuda_ms(lambda: i8.int8_matmul_fused_plain(
                x, w_q, w_scale, sx, b), iters=2, warmup=1)
            row["library_ms"] = cuda_ms(lambda: int8_library_route(
                x, w_pad, w_scale, sx, b, n))
            row["bound_ms"], row["bound_by"] = bound(
                nbytes(x, w_q, w_scale, b, got), 2 * m * k * n, "int8")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["launches"] = launches_of(
                i8.int8_matmul_fused,
                lambda: i8.int8_matmul_fused(x, w_k, w_scale, sx, b))
            log(f"[widths] int8_matmul_fused {tag}: kernel "
                f"{row['ms']:.4f} ms ({row['launches']} launch a call, "
                f"{row['launches_per_call']} chunk(s) of K), "
                f"plain {row['plain_ms']:.4f} ms, "
                f"library route (quantize + _int_mm + epilogue) "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}, {100 * row['share_of_bound']:.1f}%)")
            del w_pad
        rows.append(row)
        del x, w_q, w_k, w_scale, b, got, want
        torch.cuda.empty_cache()
    return rows


def widths_kernels(gen):
    """Phase 31a: each widened kernel against its plain version at the
    command lines' new shapes."""
    report = widths_flash(gen)
    report["query_block_attention"] = widths_query_block(gen)
    report["fused_post_attention"] = widths_tail(gen)
    report["int8_matmul_fused"] = widths_int8(gen)
    return report


def timed_forward(tag, step, batch):
    """One warm-up and one measured call of an inference step with every
    kernel's count set to 0 just before the measured call and read just
    after it: (launches, device ms, peak GiB, outputs)."""
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step(batch)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for key, v in out.items():
        require(bool(torch.isfinite(v.float()).all()),
                f"{tag}: non-finite {key}")
    log(f"[{tag}] {batch['v_feats'].shape[0]} windows: {ms:.3f} device ms, "
        f"peak {peak:.2f} GiB, launches {launches}")
    return launches, ms, peak, out


def widths_tim(tag, widths, layers, rng):
    """Phase 31b for one TIM width: an fp32 2-layer slice card vs CPU on 2
    windows; then ``layers`` layers (None: the preset's 6) on the card,
    bf16 against the card's fp32 on 2 windows and one batch of 128
    windows (kernels 1 and 2), and int8 static serving (fused heads,
    kernels 1 and 3) on the same 128."""
    import dataclasses
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg32 = C.epic_detection(**widths, num_layers=2,
                             compute_dtype="float32", use_fused_ffn=True)
    cpu_model = TimDetection(cfg32, device="cpu", generator=torch.Generator()
                             .manual_seed(SEED + 31))
    gpu_model = TimDetection(cfg32, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    batch2 = window_batch(cfg32, 2, rng)
    counters = zero_counts()
    gpu_out = make_inference_step(gpu_model, cfg32)(to_torch(batch2, "cuda"))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    require(launches["query_block_attention"] == 2
            and launches["fused_post_attention"] == 2,
            f"{tag}-slice-fp32: launches {launches}")
    t0 = time.perf_counter()
    cpu_out = make_inference_step(cpu_model, cfg32)(to_torch(batch2, "cpu"))
    log(f"[{tag}-slice-fp32] C {cfg32.encoder_width}, head dim "
        f"{cfg32.encoder_width // cfg32.nhead}, FF "
        f"{cfg32.feedforward_scale * cfg32.d_model}: CPU plain forward of 2 "
        f"windows {time.perf_counter() - t0:.2f} s; card launches {launches}")
    compare_outputs(f"{tag}-slice-fp32", gpu_out, cpu_out, SLICE_TOL)
    del cpu_model, gpu_model, gpu_out, cpu_out

    over = dict(widths) if layers is None else dict(widths, num_layers=layers)
    cfg = C.epic_detection(**over, compute_dtype="float32",
                           use_fused_ffn=True)
    torch.manual_seed(SEED + 31)
    model32 = TimDetection(cfg, device="cuda")
    state_dict = model32.state_dict()
    out32 = make_inference_step(model32, cfg)(to_torch(batch2, "cuda"))
    del model32
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    server = DetectionServer(cfg16, state_dict, device="cuda",
                             batch_size=128)
    step16 = make_inference_step(server.model, cfg16)
    out16 = step16(to_torch(batch2, "cuda"))
    diff = max(max_err(out16[k], out32[k]) for k in ("v_scores", "a_scores"))
    log(f"[{tag}-bf16] {cfg.num_layers} layers, "
        f"{sum(p.numel() for p in server.model.parameters())} params: bf16 "
        f"vs fp32 sigmoid scores on the card, 2 windows: max abs diff "
        f"{diff:.4e} (tol {BF16_SCORE_TOL})")
    require(diff <= BF16_SCORE_TOL, f"{tag}-bf16: scores drift {diff}")
    big = to_torch(window_batch(cfg16, 128, rng), "cuda")
    launches16, ms16, peak16, _ = timed_forward(f"{tag}-bf16", step16, big)
    layers_n = cfg.num_layers
    require(launches16["query_block_attention"] == layers_n
            and launches16["fused_post_attention"] == layers_n
            and launches16["int8_matmul_fused"] == 0,
            f"{tag}-bf16: launches {launches16}")
    del server, step16
    torch.cuda.empty_cache()

    cfg8 = dataclasses.replace(cfg16, quant_pallas_heads=True)
    server8 = DetectionServer.quantized(cfg8, state_dict,
                                        [to_torch(batch2, "cuda")],
                                        device="cuda", batch_size=128)
    step8 = make_inference_step(server8.model, server8.cfg)
    out8 = step8(to_torch(batch2, "cuda"))
    deltas = torch.cat([(out8[k] - out16[k]).abs().flatten()
                        for k in ("v_scores", "a_scores")])
    d_max, d_mean = deltas.max().item(), deltas.mean().item()
    log(f"[{tag}-int8] int8 vs bf16 sigmoid scores, 2 windows: max abs diff "
        f"{d_max:.4e} (tol {INT8_SCORE_MAX}), mean {d_mean:.4e} (tol "
        f"{INT8_SCORE_MEAN})")
    require(d_max <= INT8_SCORE_MAX and d_mean <= INT8_SCORE_MEAN,
            f"{tag}-int8: int8 scores drift max {d_max} mean {d_mean}")
    launches8, ms8, peak8, _ = timed_forward(f"{tag}-int8", step8, big)
    require(launches8["query_block_attention"] == layers_n
            and launches8["int8_matmul_fused"] == 2
            and launches8["fused_post_attention"] == 0,
            f"{tag}-int8: launches {launches8}")
    del server8, step8, big, state_dict
    torch.cuda.empty_cache()
    summary = {"layers": layers_n, "c": cfg.encoder_width,
               "head_dim": cfg.encoder_width // cfg.nhead,
               "ff": cfg.feedforward_scale * cfg.d_model,
               "bf16_ms_128_windows": ms16, "bf16_peak_gib": peak16,
               "int8_ms_128_windows": ms8, "int8_peak_gib": peak8,
               "bf16_vs_fp32": diff, "int8_vs_bf16_max": d_max,
               "int8_vs_bf16_mean": d_mean}
    log(f"[{tag}] summary {json.dumps(summary)}")
    return {f"{tag}-bf16": launches16, f"{tag}-int8": launches8}


def widths_vit(tmp, tag="widths-vit-h", flags=VIT_H, dh=80,
               counts=("flash_mha_wide", "flash_mha_bwd_wide")):
    """Phase 31c: the finetune CLI at VideoMAE ViT-H/16's width and depth
    (--embed_dim 1280 --depth 32 --num_heads 16: head dim 80, kernels 5
    and 5b on their 80 instances, q, k and v read in place), or at
    ``flags`` (head dim ``dh``, read in place; ``counts``: the route counts
    that must take every launch): two finetune steps of 8 clips and one
    validation batch; each step's device ms (CUDA events) beside its wall
    seconds and host share."""
    from tim_tpu_torch.ops import flash_mha as fm
    import random
    from tim_tpu_torch.extract import finetune_cli
    args = ft_args("finetune", tmp / tag, *flags, "--num_sample", "1")
    train_ds, val_ds = finetune_cli.datasets(
        args, ft_annotations(2 * FT_BATCH, SEED + 31),
        ft_annotations(FT_BATCH, SEED + 32), ft_reader)
    random.seed(SEED + 31)
    np.random.seed(SEED + 31)
    stats, launches, metrics = ft_cli_run(tag, "finetune", args, train_ds,
                                          val_ds, per=args.depth)
    routes = (dict(fm.flash_mha.routes), dict(fm.flash_mha_bwd.routes))
    bf16 = torch.bfloat16
    want = ({fm.route(bf16, dh, False): launches["flash_mha"]},
            {fm.route(bf16, dh, False, backward=True):
             launches["flash_mha_bwd"]})
    log(f"[{tag}] routes: forward {routes[0]}, backward {routes[1]}")
    require(routes == want and launches[counts[0]] == launches["flash_mha"]
            and launches[counts[1]] == launches["flash_mha_bwd"],
            f"{tag}: routes {routes}, expected {want} (the {dh} route, no "
            f"copy)")
    for i, (wall, dev) in enumerate(zip(metrics["step_s"],
                                        metrics["device_ms"])):
        data = metrics["data_s"][i]
        log(f"[{tag}] step {i}: wall {wall:.4f} s, device "
            f"{dev:.3f} ms (CUDA events over the step), host's data "
            f"{data:.4f} s ({100 * data / wall:.1f}% of the wall)")
    log(f"[{tag}] summary {json.dumps(metrics)}")
    return {tag: launches}


# Phase 31d: head dims past 256 (the column-slice routes of kernels 1, 5
# and 5b). TIM at cli --d_model 512 --nhead 2 (C 1024, head dim 512, FF
# 2048), --nhead 1 (1024) and --d_model 450 --nhead 3 (C 900, head dim
# 300: kernel 1 through the zero-padded copy to 320); ViT-L at
# finetune_cli --embed_dim 1024 --depth 24 --num_heads 2 (head dim 512).
HEADS_TIM = {"d_model": 512, "nhead": 2}
HEADS_TIM_1 = {"d_model": 512, "nhead": 1}
HEADS_TIM_3 = {"d_model": 450, "nhead": 3}
VIT_L_H2 = ("--embed_dim", "1024", "--depth", "24", "--num_heads", "2")
# kernel 1 at (batch, heads, head dim), F 100; kernels 5 / 5b at [B, H, S,
# dh]; fp32 at batch HEADS_F32_BATCH (kernel 1) and 1 (kernels 5 / 5b)
HEADS_QBA = ((128, 2, 512), (128, 1, 1024), (128, 3, 300))
HEADS_FLASH = ((8, 2, 1568, 512), (8, 1, 1568, 1024), (2, 3, 1568, 320))
HEADS_F32_BATCH = 16


def heads_cli(tmp, rng):
    """``cli.run --train --validate`` (one epoch, validation after it) at
    --d_model 512 --nhead 2 on numpy windows (EPIC widths, 2 videos to
    train, 1 to validate), then ``--validate`` resumed from its
    checkpoint: kernel 1 on its column-slice route in every validation
    batch, the resumed statistics equal to the fit's."""
    from tim_tpu_torch import cli
    from tim_tpu_torch import config as C
    cfg = C.epic_detection()
    train_ds = epic_detection_split(det_split(cfg, 2, rng), True)
    val_ds = epic_detection_split(det_split(cfg, 1, rng), False)
    width = ["--d_model", str(HEADS_TIM["d_model"]), "--nhead",
             str(HEADS_TIM["nhead"])]
    args = cli_args("detection", tmp, "--train", "--validate",
                    "--finetune_epochs", "1", *width)
    layers = cli.configs_from_args(args)[0].num_layers
    val_batches = len(val_ds) // DET_BATCH
    fit, l_train, s_train = cli_run("widths-cli-h2-train", args, train_ds,
                                    val_ds)
    require_kernel1("widths-cli-h2-train", l_train, layers, val_batches)
    args = cli_args("detection", tmp, "--validate", "--resume", str(tmp),
                    *width)
    val, l_val, s_val = cli_run("widths-cli-h2-val", args, None, val_ds)
    require_kernel1("widths-cli-h2-val", l_val, layers, val_batches)
    diff = stats_diff("widths-cli-h2-val", val, fit)
    for tag, launches in (("train", l_train), ("val", l_val)):
        require(launches["query_block_attention_cols"]
                == launches["query_block_attention"], f"widths-cli-h2-{tag}:"
                f" kernel 1 off its column-slice route: {launches}")
    log(f"[widths-cli-h2] --train --validate {s_train:.3f} s, fit "
        f"statistics {json.dumps(fit)}; --validate resumed {s_val:.3f} s, "
        f"max relative difference {diff:.3e}")
    return {"widths-cli-h2-train": l_train, "widths-cli-h2-val": l_val}


def phase_heads(card: str):
    """Phase 31d: head dims past 256. Each column-slice kernel against its
    plain version at the command lines' shapes (the gates and controls of
    31a, timed beside SDPA); TIM detection at --nhead 2 (full depth), --nhead
    1 and --d_model 450 --nhead 3 (2 layers) through ``widths_tim``; one
    ``cli.run --train --validate`` and a resumed ``--validate`` at --nhead
    2; ViT-L finetuning at --num_heads 2 (full depth). Returns (the
    kernels' rows, launches by path)."""
    import pathlib
    import tempfile
    log(f"[heads] {card}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    report = timed("heads-flash", widths_flash, gen, HEADS_FLASH,
                   f32_batch=1, time_all=True)
    report["query_block_attention"] = timed(
        "heads-query-block", widths_query_block, gen, HEADS_QBA,
        f32_batch=HEADS_F32_BATCH)
    rng = np.random.default_rng(SEED + 33)
    paths = timed("heads-tim-h2", widths_tim, "widths-tim-h2", HEADS_TIM,
                  None, rng)
    paths.update(timed("heads-tim-h1", widths_tim, "widths-tim-h1",
                       HEADS_TIM_1, 2, rng))
    paths.update(timed("heads-tim-h3", widths_tim, "widths-tim-h3",
                       HEADS_TIM_3, 2, rng))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        paths.update(timed("heads-cli-h2", heads_cli, tmp / "cli", rng))
        paths.update(timed("heads-vit-l-h2", widths_vit, tmp,
                           "widths-vit-l-h2", VIT_L_H2, 512,
                           ("flash_mha_cols", "flash_mha_bwd_cols")))
    return report, paths


# Phase 31e: Swin window attention at every head dim (kernels 4 and 4b
# past head dim 32) through Swin-B-shaped trunks with other heads, which
# the JAX package runs: A omnivore_swinB_epic(num_heads=(2, 4, 8, 16))
# (head dim 64 at every stage), B num_heads (1, 1, 1, 1) (128, 256, 512,
# 1024) and C embed_dim 120, num_heads (3, 6, 12, 24) (40, through the
# zero-padded copy to 64)
SWIN_TRUNKS = {"a": {"num_heads": (2, 4, 8, 16)},
               "b": {"num_heads": (1, 1, 1, 1)},
               "c": {"embed_dim": 120, "num_heads": (3, 6, 12, 24)}}
# kernels 4 / 4b also at [64, 2, 784, dh] (64 windows a clip: Swin-B's
# stage-1 geometry): 16 (the copy to 32), 48 (to 64), 200 (to 256) and
# 264 (the column slices, in place)
SWIN_EXTRA_DIMS = (16, 48, 200, 264)
# fp32 checks run on this many windows (two window types when shifted)
SWIN_F32_WINDOWS = 2


def swin_head_cases():
    """(tag, windows a clip, heads, head dim, token grid) of each shape of
    phase 31e: the trunks' four stages, then the extra head dims."""
    cases = []
    for name, kw in SWIN_TRUNKS.items():
        embed = kw.get("embed_dim", 128)
        for i, ((n_win, _, dims), h) in enumerate(zip(SWIN_STAGES,
                                                      kw["num_heads"])):
            cases.append((f"{name}{i + 1}", n_win, h, embed * 2 ** i // h,
                          dims))
    for dh in SWIN_EXTRA_DIMS:
        cases.append((f"dh{dh}", 64, 2, dh, SWIN_STAGES[0][2]))
    return cases


def swin_window_case(batch, n_win, heads, dh, dims, shifted, dtype, gen,
                     windows=None):
    """q/k/v (strided views of a packed projection), bias and region ids
    of ``batch`` clips of a stage (or of its first ``windows`` windows),
    the forward's output and lse, and an output gradient."""
    from tim_tpu_torch.ops import window_attention as wa
    q, k, v = swin_qkv(batch, n_win, heads, dtype, gen, dh=dh)
    bias, region = swin_bias(heads, dims, shifted, gen)
    if windows is not None:
        q, k, v = (t[:windows] for t in (q, k, v))
        region = None if region is None else region[:windows].contiguous()
    kw = {"sm_scale": dh ** -0.5}
    out, lse = wa.window_attention_with_lse(q, k, v, bias, region, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v, bias, region), kw, out, lse, do


def swin_route_check(tag, args, kw, out, lse, do):
    """One forward and one backward launch each on the plan's route (the
    route counts); in bf16 the backward twice and under
    torch.use_deterministic_algorithms, the same bits. Returns the
    routes."""
    from tim_tpu_torch.ops import window_attention as wa
    q = args[0]
    w, copied = wa.launch_plan(q.shape[-1], q.dtype, *args[:3])
    want_f = {wa.route(q.dtype, w, copied): 1}
    want_b = {wa.route(q.dtype, w, copied, backward=True): 1}
    got_f = routes_by_name(wa.window_attention,
                           lambda: wa.window_attention(*args, **kw))
    first = []
    got_b = routes_by_name(wa.window_attention_bwd, lambda: first.extend(
        g.clone() for g in wa.window_attention_bwd(*args, out, lse, do,
                                                   **kw)))
    require(got_f == want_f and got_b == want_b, f"heads-swin {tag}: "
            f"routes {got_f}, {got_b}; expected {want_f}, {want_b}")
    if q.dtype == torch.bfloat16 and w != 32:
        again = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.use_deterministic_algorithms(True)
        try:
            det = wa.window_attention_bwd(*args, out, lse, do, **kw)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        same = [torch.equal(a, b) and torch.equal(a, c)
                for a, b, c in zip(first, again, det)]
        require(all(same), f"heads-swin {tag}: the backward is not "
                f"bit-stable (dq, dk, dv, dbias: {same})")
    return {"forward": got_f, "backward": got_b}


def swin_head_kernels(gen):
    """Phase 31e's kernel rows: at every shape of ``swin_head_cases``,
    kernels 4 and 4b in fp32 (SWIN_F32_WINDOWS windows) and bf16 (one
    clip), shifted and unshifted, against their plain versions under the
    attention gates, each call on the plan's route, the bf16 gates shown
    to reject their faulty controls on trunk A's stage 1; then every bf16
    shape timed at batch 8 (shifted where the stage has windows of several
    types) beside the plain versions and SDPA with a float mask ab[type]
    (its backward with the mask requiring grad), its launches and bound.
    Returns the forward's and the backward's rows."""
    from tim_tpu_torch.ops import window_attention as wa
    rows_f, rows_b, rows_d = [], [], []
    worst = {"window_attention": 0.0, "window_attention_bwd": 0.0}
    t0 = time.perf_counter()
    for tag, n_win, h, dh, dims in swin_head_cases():
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            for shifted in ((False, True) if n_win > 1 else (False,)):
                args, kw, out, lse, do = swin_window_case(
                    1, n_win, h, dh, dims, shifted, dtype, gen,
                    windows=None if bf16 else SWIN_F32_WINDOWS)
                ctag = (f"{tag} {dtype} [{args[0].shape[0]}, {h}, 784, "
                        f"{dh}] shifted={shifted}")
                controls = bf16 and tag == "a1" and shifted
                _, err = check_attention(
                    "window_attention", wa.window_attention,
                    wa.window_attention_plain, swin_scores, args, kw,
                    f"heads {ctag}", controls=controls)
                got = wa.window_attention_bwd(*args, out, lse, do, **kw)
                torch.cuda.synchronize()
                want = wa.window_attention_bwd_plain(*args, do, **kw)
                gerr = check_grads("window_attention_bwd", got, want, bf16,
                                   f"heads {ctag}")
                if controls:
                    s = wa.window_scores(args[0], args[1], args[3], args[4],
                                         **kw)
                    bad = emulated_attention_bwd(s, *args[:3], do,
                                                 drop_delta=True, **kw)
                    ds = emulated_attention_bwd(s, *args[:3], do, **kw)[3]
                    groups = wa.dbias_groups(
                        *args[0].shape[:3],
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
                    per = -(-args[0].shape[0] // groups)
                    log(f"[heads-swin] {ctag}: dbias summed over {groups} "
                        f"window groups")
                    check_controls("window_attention_bwd", ctag, want, [
                        ("D omitted", 0, bad[0]),
                        ("dbias from one window only", 3, ds[0]),
                        ("dbias without one window group", 3,
                         ds[per:].sum(0))])
                    del s, bad, ds
                routes = swin_route_check(ctag, args, kw, out, lse, do)
                worst["window_attention"] = max(worst["window_attention"],
                                                err)
                worst["window_attention_bwd"] = max(
                    worst["window_attention_bwd"], gerr)
                if not bf16:
                    rows_f.append({"case": tag, "shape": list(args[0].shape),
                                   "dtype": str(dtype), "shifted": shifted,
                                   "max_abs_err": err,
                                   "routes": routes["forward"]})
                    rows_b.append({"case": tag, "shape": list(args[0].shape),
                                   "dtype": str(dtype), "shifted": shifted,
                                   "max_abs_err": gerr,
                                   "routes": routes["backward"]})
                del args, out, lse, do, got, want
        torch.cuda.empty_cache()
    log(f"[heads-swin] every shape agrees with the plain versions, fp32 and "
        f"bf16, shifted and unshifted ({time.perf_counter() - t0:.2f} s)")

    for tag, n_win, h, dh, dims in swin_head_cases():
        shifted = n_win > 1
        args, kw, out, lse, do = swin_window_case(
            8, n_win, h, dh, dims, shifted, torch.bfloat16, gen)
        q, k, v, bias, region = args
        bw, _, n, _ = q.shape
        w, copied = wa.launch_plan(dh, q.dtype, q, k, v)
        got = wa.window_attention(*args, **kw)
        torch.cuda.synchronize()
        ok, err, rel = attention_close(got, wa.window_attention_plain(*args,
                                                                      **kw))
        require(ok, f"heads-swin {tag} bf16 batch 8: max abs {err}, "
                f"relative RMS {rel}")
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_kw = {"attn_mask": mask, "scale": dh ** -0.5}
        row = {"case": tag, "shape": [bw, h, n, dh], "shifted": shifted,
               "instance": w, "copied": copied, "max_abs_err": err,
               **time_forward(
                   wa.window_attention, wa.window_attention_with_lse,
                   wa.window_attention_plain,
                   lambda: F.scaled_dot_product_attention(*lib_qkv,
                                                          **lib_kw),
                   sdpa_with_grad(*lib_qkv, **lib_kw), args, kw,
                   nbytes(q, k, v, bias, region, got), bw * h * n * n, dh)}
        row["route"] = next(iter(routes_by_name(
            wa.window_attention, lambda: wa.window_attention(*args, **kw))))
        row["launches"] = launches_of(wa.window_attention,
                                      lambda: wa.window_attention(*args,
                                                                  **kw))
        row["library"] = sdpa_backend(*lib_qkv, **lib_kw)
        log_forward("window_attention", f"heads {tag} [{bw}, {h}, {n}, "
                    f"{dh}] shifted={shifted} ({row['route']})", row,
                    "masked scaled_dot_product_attention",
                    max_err(F.scaled_dot_product_attention(
                        *lib_qkv, **lib_kw).reshape(got.shape), got))
        rows_f.append(row)
        del got
        grads = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        gerr = check_grads("window_attention_bwd", grads,
                           wa.window_attention_bwd_plain(*args, do, **kw),
                           True, f"heads {tag} bf16 batch 8")
        ms_bound, by = attention_bwd_bound(
            q, nbytes(q, k, v, out, do, *grads[:3], lse, bias, region,
                      grads[3]))
        del grads
        torch.cuda.empty_cache()
        brow = {"case": tag, "shape": [bw, h, n, dh], "shifted": shifted,
                "instance": w, "copied": copied, "max_abs_err": gerr,
                "bound_ms": ms_bound, "bound_by": by}
        brow["route"] = next(iter(routes_by_name(
            wa.window_attention_bwd, lambda: wa.window_attention_bwd(
                *args, out, lse, do, **kw))))
        brow["launches"] = launches_of(wa.window_attention_bwd, lambda:
                                       wa.window_attention_bwd(
                                           *args, out, lse, do, **kw))
        brow["ms"] = cuda_ms(lambda: wa.window_attention_bwd(
            *args, out, lse, do, **kw), iters=5)
        brow["plain_ms"] = cuda_ms(lambda: wa.window_attention_bwd_plain(
            *args, do, **kw), iters=2, warmup=1)
        brow["share_of_bound"] = ms_bound / brow["ms"]
        torch.cuda.empty_cache()
        lib_do = do.reshape(lib_qkv[0].shape)
        try:
            brow["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do, mask)
            brow["library"] = ("scaled_dot_product_attention backward with "
                               "a float mask ab[type] that requires grad")
        except RuntimeError as e:   # no backend gives the mask's gradient
            log(f"[heads-swin] SDPA cannot give dbias at {tag}: {e}")
            brow["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do,
                                             mask.detach())
            brow["library"] = ("scaled_dot_product_attention backward, mask "
                               "without grad")
        log(f"[heads-swin] window_attention_bwd {tag} [{bw}, {h}, {n}, {dh}]"
            f" bf16 shifted={shifted} ({brow['route']}): kernel "
            f"{brow['ms']:.4f} ms ({brow['launches']} launch a call), plain "
            f"{brow['plain_ms']:.4f} ms, {brow['library']} "
            f"{brow['library_ms']:.4f} ms (kernel / SDPA "
            f"{brow['ms'] / brow['library_ms']:.3f}), bound "
            f"{ms_bound:.4f} ms ({by}; {100 * brow['share_of_bound']:.1f}%)")
        rows_b.append(brow)
        if tag == "a1":
            rows_d.append(swin_dbias_row(tag, args, kw, out, lse, do,
                                         brow["library_ms"]))
        del args, q, k, v, bias, region, out, lse, do, lib_qkv, mask, lib_do
        torch.cuda.empty_cache()
    f32_f, f32_b = swin_f32_rows(gen)
    return {"window_attention": rows_f, "window_attention_bwd": rows_b,
            "window_attention_dbias": rows_d, "f32": f32_f, "f32_bwd": f32_b,
            "worst": worst}


def swin_dbias_row(tag, args, kw, out, lse, do, library_ms):
    """The bf16 dbias pass alone (``window_attention_dbias``) at a timed
    shape: held to the plain backward's dbias, its bits equal call to
    call, timed beside the plain backward and its bound (two products of
    2 N^2 dh a (window, head))."""
    from tim_tpu_torch.ops import window_attention as wa
    q, k, v, bias, region = args
    delta = (do.float() * out.float()).sum(-1)
    got = wa.window_attention_dbias(*args, lse, delta, do, **kw)
    again = wa.window_attention_dbias(*args, lse, delta, do, **kw)
    torch.cuda.synchronize()
    want = wa.window_attention_bwd_plain(*args, do, **kw)[3]
    ok, err, rel = grad_close(got, want, True)
    require(ok and torch.equal(got, again), f"heads-swin {tag} dbias pass: "
            f"max abs {err}, relative RMS {rel}, repeat bit-equal "
            f"{torch.equal(got, again)}")
    bw, h, n, dh = q.shape
    row = {"case": tag, "shape": [bw, h, n, dh], "max_abs_err": err,
           "ms": cuda_ms(lambda: wa.window_attention_dbias(
               *args, lse, delta, do, **kw), iters=5),
           "plain_ms": cuda_ms(lambda: wa.window_attention_bwd_plain(
               *args, do, **kw), iters=2, warmup=1),
           "library_ms": library_ms}
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(q, k, v, do, lse, delta, bias, region, got),
        4 * bw * h * n * n * dh, "bf16")
    log(f"[heads-swin] window_attention_dbias {tag} [{bw}, {h}, {n}, {dh}] "
        f"bf16: the dbias pass alone {row['ms']:.4f} ms (groups "
        f"{wa.dbias_groups(bw, h, n, torch.cuda.get_device_properties(0).multi_processor_count)}),"
        f" plain backward {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs "
        f"{err:.3e}, relative RMS {rel:.3e}")
    return row


def swin_f32_rows(gen):
    """Kernels 4 and 4b in fp32 (the CUDA-core routes) timed at trunk A's
    stage 1 on one clip ([64, 2, 784, 64], shifted) beside the plain
    versions and fp32 SDPA with the float mask, against the fp32 peak of
    the CUDA cores."""
    from tim_tpu_torch.ops import window_attention as wa
    tag, n_win, h, dh, dims = swin_head_cases()[0]
    args, kw, out, lse, do = swin_window_case(1, n_win, h, dh, dims, True,
                                              torch.float32, gen)
    q, k, v, bias, region = args
    bw, _, n, _ = q.shape
    got = wa.window_attention(*args, **kw)
    ok, err, _ = attention_close(got, wa.window_attention_plain(*args, **kw))
    require(ok, f"heads-swin {tag} fp32 one clip: max abs {err}")
    lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
    lib_kw = {"attn_mask": mask, "scale": dh ** -0.5}
    row = {"case": tag, "shape": [bw, h, n, dh], "max_abs_err": err,
           "ms": cuda_ms(lambda: wa.window_attention(*args, **kw), iters=3),
           "plain_ms": cuda_ms(lambda: wa.window_attention_plain(*args, **kw),
                               iters=3),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               *lib_qkv, **lib_kw), iters=3)}
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(q, k, v, bias, region, got), 4 * bw * h * n * n * dh, "fp32")
    grads = wa.window_attention_bwd(*args, out, lse, do, **kw)
    gerr = check_grads("window_attention_bwd", grads,
                       wa.window_attention_bwd_plain(*args, do, **kw), False,
                       f"heads {tag} fp32 one clip")
    brow = {"case": tag, "shape": [bw, h, n, dh], "max_abs_err": gerr,
            "ms": cuda_ms(lambda: wa.window_attention_bwd(
                *args, out, lse, do, **kw), iters=2, warmup=1),
            "plain_ms": cuda_ms(lambda: wa.window_attention_bwd_plain(
                *args, do, **kw), iters=2, warmup=1),
            "library_ms": sdpa_bwd_ms(*lib_qkv, do.reshape(lib_qkv[0].shape),
                                      mask)}
    brow["bound_ms"], brow["bound_by"] = bound(
        nbytes(q, k, v, out, do, *grads[:3], lse, bias, region, grads[3]),
        10 * bw * h * n * n * dh, "fp32")
    log(f"[heads-swin] fp32 {tag} [{bw}, {h}, {n}, {dh}]: window_attention "
        f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA "
        f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"{row['bound_by']}); window_attention_bwd {brow['ms']:.4f} ms "
        f"(plain {brow['plain_ms']:.4f}, SDPA backward "
        f"{brow['library_ms']:.4f}, bound {brow['bound_ms']:.4f} "
        f"{brow['bound_by']})")
    return row, brow


def swin_trunk(name, dtype, device, **kw):
    """Trunk ``name`` of SWIN_TRUNKS (``omnivore_swinB_epic`` with its
    heads; ``kw``: depths), generator seeded SEED, in eval mode."""
    from tim_tpu_torch.models.backbones import swin3d
    return swin3d.omnivore_swinB_epic(
        dtype, device=device, generator=torch.Generator().manual_seed(SEED),
        **SWIN_TRUNKS[name], **kw).eval()


def swin_trunk_routes(tag, fn, call, want):
    """``call()`` with kernel 4's (or 4b's) route counts set to 0 just
    before and read just after: every launch on the routes ``want``."""
    got = routes_by_name(fn, call)
    log(f"[{tag}] routes {got}")
    require(set(got) == set(want), f"{tag}: routes {got}, expected only "
            f"{sorted(want)}")
    return got


def swin_trunk_forward(tag, name, clips, want_routes, **kw):
    """The bf16 forward of 8 clips through trunk ``name``, timed after a
    warm-up, every count set to 0 just before it: (launches, device ms,
    features)."""
    from tim_tpu_torch.ops import window_attention as wa
    model = swin_trunk(name, "bfloat16", "cuda", **kw)
    x = torch.from_numpy(clips).cuda()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        counters = zero_counts()
        wa.window_attention.routes.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        feats = model(x)
        end.record()
        torch.cuda.synchronize()
    launches = read_counts(counters)
    ms = start.elapsed_time(end)
    routes = dict(wa.window_attention.routes)
    blocks = sum(model.depths)
    log(f"[{tag}] {x.shape[0]} clips, depths {model.depths}: {ms:.3f} "
        f"device ms, launches {launches}, routes {routes}")
    require(feats.shape == (x.shape[0], model.num_features)
            and bool(torch.isfinite(feats.float()).all()),
            f"{tag}: features {tuple(feats.shape)} or non-finite")
    require(launches["window_attention"] == blocks
            and attention_launches(launches) == blocks
            and set(routes) == set(want_routes)
            and sum(routes.values()) == blocks,
            f"{tag}: launches {launches}, routes {routes}, expected {blocks} "
            f"on {sorted(want_routes)}")
    del model
    torch.cuda.empty_cache()
    return launches, ms, feats


def swin_trunk_step(tag, name, depths, want_routes, batch=TRAIN_BATCH):
    """One bf16 ``TwoHeadViT`` step over trunk ``name`` at ``depths`` on
    ``batch`` clips through ``SwinSteps``: a finite loss, the launches of
    kernel 4b by route as ``want_routes`` gives them. Returns the
    launches."""
    from tim_tpu_torch.ops import window_attention as wa
    model = train_model("swin", "bfloat16", "cuda", depths=depths,
                        **SWIN_TRUNKS[name])
    run = SwinSteps(model, batch)
    counters = zero_counts()
    wa.window_attention_bwd.routes.clear()
    events, losses = [], []
    run(1, events, losses)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    routes = dict(wa.window_attention_bwd.routes)
    blocks = sum(depths)
    log(f"[{tag}] one step of {batch} clips, depths {depths}: device "
        f"{events[0][0].elapsed_time(events[0][1]):.3f} ms, loss "
        f"{float(losses[0]):.5f}, launches {launches}, backward routes "
        f"{routes}")
    require(np.isfinite(float(losses[0])), f"{tag}: non-finite loss")
    require(launches["window_attention_bwd"] == blocks
            and routes == want_routes,
            f"{tag}: backward launches {launches}, routes {routes}, "
            f"expected {want_routes}")
    del run, model
    torch.cuda.empty_cache()
    return launches


def swin_deterministic_step(tag):
    """Two gradients of one bf16 ``TwoHeadViT`` loss over trunk A (depths
    (2, 2, 2, 2), 2 clips) under torch.use_deterministic_algorithms: kernel
    4b's route past head dim 32 is atomic-free, and every parameter's
    gradient comes out with the same bits both times."""
    model = train_model("swin", "bfloat16", "cuda", depths=(2, 2, 2, 2),
                        **SWIN_TRUNKS["a"])
    rng = np.random.default_rng(SEED + 35)
    video = torch.from_numpy(rng.normal(size=(2, *BACKBONES["omnivore"][1]))
                             .astype(np.float32)).cuda()
    labels = torch.tensor([3, 5], device="cuda")
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            two_head_loss(model, video, labels, labels).backward()
            torch.cuda.synchronize()
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
    log(f"[{tag}] two deterministic gradients of {len(grads[0])} "
        f"parameters: {len(differ)} differ {differ[:5]}")
    require(not differ, f"{tag}: gradients differ between two "
            f"deterministic runs: {differ[:10]}")
    del model, grads
    torch.cuda.empty_cache()


def swin_head_trunks(card):
    """Phase 31e's trunks: A at full depth (the fp32 forward of one clip
    card vs CPU, the bf16 forward of 8 clips, 2 + 5 finetune steps at batch
    8, a deterministic step bit-equal twice), B (the bf16 forward of 8
    clips at full depth, one step at depths (2, 2, 2, 2)) and C (both at
    depths (2, 2, 2, 2)). Returns launches by path."""
    from tim_tpu_torch.ops import window_attention as wa
    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(SEED + 34)
    clips = rng.normal(size=(TRAIN_BATCH, *BACKBONES["omnivore"][1])).astype(
        np.float32)
    paths = {}
    # A: fp32 one clip, card vs CPU
    cpu_model = swin_trunk("a", "float32", "cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(clips[:1])
    counters = zero_counts()
    wa.window_attention.routes.clear()
    with torch.inference_mode():
        gpu = gpu_model(x.cuda())
    torch.cuda.synchronize()
    launches = read_counts(counters)
    require(launches["window_attention"] == 24
            and dict(wa.window_attention.routes) == {
                wa.route(f32, 64, False): 24},
            f"heads-swin-a-fp32: launches {launches}, routes "
            f"{dict(wa.window_attention.routes)}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = cpu_model(x)
    err = max_err(gpu.cpu(), cpu)
    log(f"[heads-swin-a-fp32] trunk A ({SWIN_TRUNKS['a']}), full depth, 1 "
        f"clip: CPU plain forward {time.perf_counter() - t0:.2f} s; card vs "
        f"CPU max_abs_err={err:.3e} (tol {SLICE_TOL}); launches {launches}")
    require(err <= SLICE_TOL and bool(torch.isfinite(gpu).all()),
            f"heads-swin-a-fp32: card vs CPU {err} > {SLICE_TOL}")
    paths["heads-swin-a-fp32"] = launches
    del cpu_model, gpu_model, gpu, cpu
    torch.cuda.empty_cache()
    # A: an fp32 gradient slice (depths (2, 2, 2, 2)), card vs CPU
    counters = zero_counts()
    grad_err = phase_grad_slice_fp32("swin", **SWIN_TRUNKS["a"])
    paths["heads-swin-a-grad-fp32"] = read_counts(counters)
    require(paths["heads-swin-a-grad-fp32"]["window_attention_bwd_f32"] == 8,
            f"heads-swin-a-grad-fp32: launches "
            f"{paths['heads-swin-a-grad-fp32']}")
    # A: bf16 forward of 8 clips, every launch on the 64 route
    paths["heads-swin-a-bf16"], ms_a, _ = swin_trunk_forward(
        "heads-swin-a-bf16", "a", clips, [wa.route(bf16, 64, False)])
    # A: 2 + 5 finetune steps at batch 8
    model = train_model("swin", "bfloat16", "cuda", **SWIN_TRUNKS["a"])
    wa.window_attention_bwd.routes.clear()
    launches, metrics = train_run("heads-swin-a-train", model,
                                  SwinSteps(model, TRAIN_BATCH),
                                  "window_attention", 24, TRAIN_BATCH)
    want = wa.route(bf16, 64, False, backward=True)
    routes = dict(wa.window_attention_bwd.routes)
    require(set(routes) == {want}, f"heads-swin-a-train: backward routes "
            f"{routes}, expected only {want}")
    log(f"[heads-swin-a-train] summary {json.dumps(metrics)}")
    paths["heads-swin-a-train"] = launches
    del model
    torch.cuda.empty_cache()
    swin_deterministic_step("heads-swin-a-deterministic")
    # B: the bf16 forward at full depth; one step at depths (2, 2, 2, 2)
    paths["heads-swin-b-bf16"], ms_b, _ = swin_trunk_forward(
        "heads-swin-b-bf16", "b", clips,
        [wa.route(bf16, w, False) for w in (128, 256, 512, 1024)])
    paths["heads-swin-b-train"] = swin_trunk_step(
        "heads-swin-b-train", "b", (2, 2, 2, 2),
        {wa.route(bf16, w, False, backward=True): 2
         for w in (128, 256, 512, 1024)})
    # C: head dim 40 through the copy to 64
    paths["heads-swin-c-bf16"], ms_c, _ = swin_trunk_forward(
        "heads-swin-c-bf16", "c", clips, [wa.route(bf16, 64, True)],
        depths=(2, 2, 2, 2))
    paths["heads-swin-c-train"] = swin_trunk_step(
        "heads-swin-c-train", "c", (2, 2, 2, 2),
        {wa.route(bf16, 64, True, backward=True): 8})
    summary = {"a_bf16_ms_8_clips": ms_a, "b_bf16_ms_8_clips": ms_b,
               "c_bf16_ms_8_clips_depths_2222": ms_c,
               "a_fp32_card_vs_cpu": err, "a_fp32_grad_slice": grad_err,
               "a_train": metrics}
    log(f"[heads-swin] summary {json.dumps(summary)}")
    return paths


def phase_swin_heads(card: str):
    """Phase 31e: Swin window attention at every head dim. Returns (the
    kernels' rows, launches by path)."""
    log(f"[heads-swin] {card}")
    report = timed("heads-swin-kernels", swin_head_kernels,
                   torch.Generator(device="cuda").manual_seed(SEED + 34))
    paths = timed("heads-swin-trunks", swin_head_trunks, card)
    return report, paths


def phase_widths(card: str):
    """Phase 31: the widths the command lines take beyond the presets.
    31a, each widened kernel against its plain version at the new shapes;
    31b, TIM detection at --d_model 1280 --nhead 16 (full depth) and
    --d_model 364 --nhead 8 (2 layers); 31c, the finetune CLI at ViT-H/16.
    Returns (the kernels' rows, launches by path)."""
    import pathlib
    import tempfile
    log(f"[widths] {card}")
    report = timed("widths-kernels", widths_kernels,
                   torch.Generator(device="cuda").manual_seed(SEED + 31))
    rng = np.random.default_rng(SEED + 31)
    paths = timed("widths-tim-wide", widths_tim, "widths-tim-wide",
                  WIDE_TIM, None, rng)
    paths.update(timed("widths-tim-odd", widths_tim, "widths-tim-odd",
                       ODD_TIM, 2, rng))
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(timed("widths-vit-h", widths_vit, pathlib.Path(tmp)))
    return report, paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].split(",")
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clock[0]) * 1e6
    log(f"[device] SM clock: max {clock[0].strip()} MHz, now "
        f"{clock[1].strip()} MHz (the exponential floors use the max)")
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    # the plain CPU references: no more threads than the CPUs allowed
    threads = min(torch.get_num_threads(), usable_cpus())
    log(f"[device] host: {os.cpu_count()} CPUs visible, {usable_cpus()} "
        f"usable; torch CPU threads {torch.get_num_threads()} -> {threads}")
    torch.set_num_threads(threads)

    lib = timed("build", phase_build)
    log(f"[build] {lib}")

    kernel_report = timed("kernels", phase_kernels)
    linear_report = timed("linear", phase_linear_rounding,
                          torch.Generator(device="cuda").manual_seed(SEED))
    log(f"[linear] summary {json.dumps(linear_report)}")
    kernel_report["bias_act"] = check_bias_act(
        torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    state_dict, batch2, fp32_out = timed("slice-fp32", phase_slice_fp32, rng)
    from tim_tpu_torch import config as C
    video = synthetic_video(C.epic_detection(), rng)
    launches_bf16, serving, out16, threshold = timed(
        "serve-bf16", phase_serve_bf16, state_dict, batch2, fp32_out, video)
    log(f"[serve-bf16] summary {json.dumps(serving)}")
    err8, cal_rel = timed("int8-slice-fp32", phase_int8_slice_fp32,
                          state_dict, batch2)
    launches_int8, serving8 = timed(
        "serve-int8", phase_serve_int8, "serve-int8", state_dict, batch2,
        out16, video, threshold, False)
    serving8.update(int8_fp32_card_vs_cpu=err8, calibration_rel=cal_rel)
    log(f"[serve-int8] summary {json.dumps(serving8)}")
    launches_fast, serving_fast = timed(
        "serve-int8-fast-scores", phase_serve_int8, "serve-int8-fast-scores",
        state_dict, batch2, out16, video, threshold, True)
    log(f"[serve-int8-fast-scores] summary {json.dumps(serving_fast)}")
    del fp32_out, out16          # state_dict, batch2: phase 21
    torch.cuda.empty_cache()

    backbone_report, backbone_paths = phase_backbones(
        torch.Generator(device="cuda").manual_seed(SEED))
    kernel_report.update(backbone_report)
    training_report, training_paths = phase_training(
        torch.Generator(device="cuda").manual_seed(SEED + 1))
    kernel_report.update(training_report)
    detection_paths, det_splits = phase_detection_training()
    rec_report, recognition_paths, (rec_train_ds, rec_val_ds,
                                    rec_trained) = \
        phase_recognition(torch.Generator(device="cuda").manual_seed(SEED + 2))
    kernel_report["query_block_attention"]["recognition"] = rec_report
    cli_paths = phase_cli_and_gate(det_splits, rec_val_ds, rec_trained)
    dp_paths = timed("data-parallel", phase_data_parallel, det_splits,
                     (rec_train_ds, rec_val_ds))
    card = smi.stdout.strip().splitlines()[0]
    tp_paths = timed("tensor-parallel", phase_tensor_parallel, card)
    jax_paths = timed("jax-checkpoints", phase_jax_checkpoints, det_splits,
                      rec_val_ds, rec_trained, video, batch2, card)
    del det_splits, rec_train_ds, rec_val_ds, rec_trained
    audio_paths = phase_audio()
    files_paths = timed("files", phase_files, card)
    hdf5_paths = timed("hdf5", phase_hdf5, card)
    jpeg_paths, jpeg_state = timed("jpeg", phase_jpeg, card)
    autoaug_paths = timed("autoaug", phase_autoaug, card, jpeg_state)
    del jpeg_state
    torch.cuda.empty_cache()
    media_paths = phase_media(state_dict, batch2)
    del state_dict, batch2
    torch.cuda.empty_cache()
    ft_cli_paths = timed("finetune-cli", phase_finetune_cli, card)
    widths_report, widths_paths = timed("widths", phase_widths, card)
    for name, rows in widths_report.items():
        kernel_report[name]["widths"] = rows
    heads_report, heads_paths = timed("heads", phase_heads, card)
    for name, rows in heads_report.items():
        kernel_report[name]["heads"] = rows
    swin_report, swin_paths = timed("heads-swin", phase_swin_heads, card)
    kernel_report["window_attention"]["max_abs_err_past_32"] = \
        swin_report["worst"]["window_attention"]
    kernel_report["window_attention_bwd"]["max_abs_err_past_32"] = \
        swin_report["worst"]["window_attention_bwd"]
    # kernels 4 / 4b past head dim 32, by source: the first timed shape of
    # each (trunk A's stage 1 for the 64 routes and the dbias pass, B's
    # for the others), every timed shape beside the wgmma forward's
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, rows, pick in (
            ("window_attention_wide", "window_attention",
             lambda r: r["route"] == "wgmma 64"),
            ("window_attention_256", "window_attention",
             lambda r: r["route"] == "wgmma 128"),
            ("window_attention_cols", "window_attention",
             lambda r: " slices " in r["route"]),
            ("window_attention_bwd_wide", "window_attention_bwd",
             lambda r: r["route"].startswith("wgmma two passes 64")),
            ("window_attention_bwd_cols", "window_attention_bwd",
             lambda r: " slices " in r["route"]),
            ("window_attention_dbias", "window_attention_dbias",
             lambda r: True)):
        timed_rows = [r for r in swin_report[rows] if "ms" in r]
        first = next(r for r in timed_rows if pick(r))
        kernel_report[name] = {**{key: first[key] for key in keys},
                               "shape": first["shape"]}
        if name in ("window_attention_wide", "window_attention_bwd_wide"):
            kernel_report[name]["per_shape"] = timed_rows
    for name, row in (("window_attention_f32", swin_report["f32"]),
                      ("window_attention_bwd_f32", swin_report["f32_bwd"])):
        kernel_report[name] = {**{key: row[key] for key in keys},
                               "shape": row["shape"]}
    # the column-slice routes past head dim 256: the first timed shape
    # (kernel 1's [128, 2, 798, 512], kernel 5 / 5b's [8, 2, 1568, 512]),
    # every timed shape beside it
    for name in ("query_block_attention", "flash_mha", "flash_mha_bwd"):
        timed_rows = [r for r in heads_report[name] if "ms" in r]
        first = timed_rows[0]
        kernel_report[f"{name}_cols"] = {
            **{key: first[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "library")},
            "shape": first["shape"], "per_shape": timed_rows}
    # the routes at head dims 65-128: ViT-H/16's [8, 16, 1568, 80] first,
    # every timed shape beside it
    for name in ("flash_mha", "flash_mha_bwd"):
        timed_rows = [r for r in widths_report[name] if "ms" in r]
        first = timed_rows[0]
        kernel_report[f"{name}_wide"] = {
            **{key: first[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")},
            "shape": first["shape"], "per_shape": timed_rows}
    by_path = {"serve-bf16": launches_bf16, "serve-int8": launches_int8,
               "serve-int8-fast-scores": launches_fast, **backbone_paths,
               **training_paths, **detection_paths, **recognition_paths,
               **cli_paths, **dp_paths, **tp_paths, **jax_paths,
               **audio_paths, **files_paths, **hdf5_paths, **jpeg_paths,
               **autoaug_paths,
               **media_paths, **ft_cli_paths, **widths_paths,
               **heads_paths, **swin_paths}
    for path in ("serve-rec-bf16", "rec-val", "det-map", "cli-det-train",
                 "cli-det-val", "cli-det-dump", "cli-rec-val",
                 "cli-rec-dump", "gate-detection", "gate-recognition",
                 "dp-det-train", "dp-det-dump", "dp-rec-train",
                 "dp-rec-dump", "tp-bf16-val", "tp-bf16-sp-val",
                 "tp-fused-val", "jax-serve-bf16", "jax-cli-rec-val",
                 "orbax-serve-bf16", "orbax-serve-int8", "files-det-train",
                 "files-det-run", "files-det-dump", "files-rec-val"):
        require(by_path[path]["query_block_attention"] > 0,
                f"{path}: kernel 1 never launched")
    for path in ("gate-detection", "jax-serve-int8", "orbax-serve-int8"):
        require(by_path[path]["int8_matmul_fused"] > 0,
                f"{path}: kernel 3 never launched")
    for path in ("tp-fused-val", "jax-serve-bf16", "orbax-serve-bf16"):
        require(by_path[path]["fused_post_attention"] > 0,
                f"{path}: kernel 2 never launched")
    require(by_path["rec-train"]["query_block_attention"] == 0,
            "rec-train: kernel 1 launched")
    for path, kernels in (
            ("media-frames-bf16", ("window_attention", "flash_mha",
                                   "query_block_attention",
                                   "fused_post_attention")),
            ("media-frames-fast", ("window_attention", "flash_mha")),
            ("media-int8", ("window_attention", "flash_mha",
                            "int8_matmul_fused")),
            ("extract-omnivore-int8", ("window_attention",)),
            ("jpeg-extract-omnivore", ("window_attention",)),
            ("jpeg-extract-videomae", ("flash_mha",)),
            ("autoaug-extract-omnivore", ("window_attention",)),
            ("autoaug-extract-videomae", ("flash_mha",)),
            ("extract-videomae-int8", ("flash_mha",)),
            ("ft-cli-pretrain", ("flash_mha", "flash_mha_bwd")),
            ("ft-cli-finetune", ("flash_mha", "flash_mha_bwd")),
            ("jax-ft-cli-finetune", ("flash_mha", "flash_mha_bwd")),
            ("widths-tim-wide-bf16", ("query_block_attention",
                                      "fused_post_attention")),
            ("widths-tim-wide-int8", ("query_block_attention",
                                      "int8_matmul_fused")),
            ("widths-tim-odd-bf16", ("query_block_attention",
                                     "fused_post_attention")),
            ("widths-tim-odd-int8", ("query_block_attention",
                                     "int8_matmul_fused")),
            ("widths-vit-h", ("flash_mha", "flash_mha_bwd", "flash_mha_wide",
                              "flash_mha_bwd_wide")),
            ("widths-tim-h2-bf16", ("query_block_attention",
                                    "query_block_attention_cols",
                                    "fused_post_attention")),
            ("widths-tim-h2-int8", ("query_block_attention",
                                    "query_block_attention_cols",
                                    "int8_matmul_fused")),
            ("widths-tim-h1-bf16", ("query_block_attention_cols",)),
            ("widths-tim-h3-bf16", ("query_block_attention_cols",)),
            ("widths-cli-h2-train", ("query_block_attention_cols",)),
            ("widths-cli-h2-val", ("query_block_attention_cols",)),
            ("widths-vit-l-h2", ("flash_mha", "flash_mha_bwd",
                                 "flash_mha_cols", "flash_mha_bwd_cols")),
            ("heads-swin-a-fp32", ("window_attention_f32",)),
            ("heads-swin-a-grad-fp32", ("window_attention_f32",
                                        "window_attention_bwd_f32")),
            ("heads-swin-a-bf16", ("window_attention_wide",)),
            ("heads-swin-a-train", ("window_attention_wide",
                                    "window_attention_bwd_wide",
                                    "window_attention_dbias")),
            ("heads-swin-b-bf16", ("window_attention_256",
                                   "window_attention_cols")),
            ("heads-swin-b-train", ("window_attention_256",
                                    "window_attention_cols",
                                    "window_attention_bwd_wide",
                                    "window_attention_bwd_cols",
                                    "window_attention_dbias")),
            ("heads-swin-c-bf16", ("window_attention_wide",)),
            ("heads-swin-c-train", ("window_attention_bwd_wide",
                                    "window_attention_dbias"))):
        for name in kernels:
            require(by_path[path][name] > 0,
                    f"{path}: {name} never launched")
    # past head dim 256 every launch of kernels 1, 5 and 5b took a
    # column-slice route (none the plain version, which does not count)
    for path, pairs in (
            ("widths-tim-h2-bf16", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-tim-h2-int8", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-tim-h1-bf16", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-tim-h1-int8", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-tim-h3-bf16", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-tim-h3-int8", (("query_block_attention",
                                     "query_block_attention_cols"),)),
            ("widths-vit-l-h2", (("flash_mha", "flash_mha_cols"),
                                 ("flash_mha_bwd", "flash_mha_bwd_cols")))):
        for total, part in pairs:
            require(by_path[path][total] == by_path[path][part],
                    f"{path}: {by_path[path][total]} launches of {total}, "
                    f"{by_path[path][part]} on its column-slice route")
    sources = {
        # name: (source, TPU kernel, the serving path whose count is reported)
        "query_block_attention": ("tim_tpu_torch/csrc/query_block_attention.cu",
                                  "tim_tpu/ops/pallas_attention.py:54",
                                  "serve-bf16"),
        "fused_post_attention": ("tim_tpu_torch/csrc/fused_post_attention.cu",
                                 "tim_tpu/ops/pallas_fused.py:109",
                                 "serve-bf16"),
        "int8_matmul_fused": ("tim_tpu_torch/csrc/int8_matmul_fused.cu",
                              "tim_tpu/ops/pallas_int8.py:50", "serve-int8"),
        "window_attention": ("tim_tpu_torch/csrc/window_attention.cu",
                             "tim_tpu/ops/pallas_swin.py:71",
                             "extract-omnivore"),
        "flash_mha": ("tim_tpu_torch/csrc/flash_mha.cu",
                      "tim_tpu/ops/flash.py:82", "extract-videomae"),
        "window_attention_bwd": ("tim_tpu_torch/csrc/window_attention_bwd.cu",
                                 "tim_tpu/ops/pallas_swin.py:109",
                                 "finetune-swin"),
        "flash_mha_bwd": ("tim_tpu_torch/csrc/flash_mha_bwd.cu",
                          "tim_tpu/ops/flash.py:71", "finetune-vit"),
        # kernel 5 / 5b's routes at head dims 65-128 (ViT-H/16's step)
        "flash_mha_wide": ("tim_tpu_torch/csrc/flash_mha_wide.cu",
                           "tim_tpu/ops/flash.py:82", "widths-vit-h"),
        "flash_mha_bwd_wide": ("tim_tpu_torch/csrc/flash_mha_bwd_wide.cu",
                               "tim_tpu/ops/flash.py:71", "widths-vit-h"),
        # kernels 1, 5 / 5b past head dim 256 (TIM at --nhead 2, ViT-L at
        # --num_heads 2)
        "query_block_attention_cols": (
            "tim_tpu_torch/csrc/query_block_attention_cols.cu",
            "tim_tpu/ops/pallas_attention.py:54", "widths-tim-h2-bf16"),
        "flash_mha_cols": ("tim_tpu_torch/csrc/flash_mha_cols.cu",
                           "tim_tpu/ops/flash.py:82", "widths-vit-l-h2"),
        "flash_mha_bwd_cols": ("tim_tpu_torch/csrc/flash_mha_bwd_cols.cu",
                               "tim_tpu/ops/flash.py:71", "widths-vit-l-h2"),
        # kernel 4 / 4b's routes past head dim 32 (trunks A, B at full
        # depth: Swin-B's widths at num_heads (2, 4, 8, 16), (1, 1, 1, 1))
        "window_attention_wide": (
            "tim_tpu_torch/csrc/window_attention_wide.cu",
            "tim_tpu/ops/pallas_swin.py:71", "heads-swin-a-bf16"),
        "window_attention_256": (
            "tim_tpu_torch/csrc/window_attention_256.cu",
            "tim_tpu/ops/pallas_swin.py:71", "heads-swin-b-bf16"),
        "window_attention_cols": (
            "tim_tpu_torch/csrc/window_attention_cols.cu",
            "tim_tpu/ops/pallas_swin.py:71", "heads-swin-b-bf16"),
        "window_attention_f32": (
            "tim_tpu_torch/csrc/window_attention_f32.cu",
            "tim_tpu/ops/pallas_swin.py:71", "heads-swin-a-fp32"),
        "window_attention_bwd_wide": (
            "tim_tpu_torch/csrc/window_attention_bwd_wide.cu",
            "tim_tpu/ops/pallas_swin.py:109", "heads-swin-a-train"),
        "window_attention_bwd_cols": (
            "tim_tpu_torch/csrc/window_attention_bwd_cols.cu",
            "tim_tpu/ops/pallas_swin.py:109", "heads-swin-b-train"),
        "window_attention_bwd_f32": (
            "tim_tpu_torch/csrc/window_attention_bwd_f32.cu",
            "tim_tpu/ops/pallas_swin.py:109", "heads-swin-a-grad-fp32"),
        "window_attention_dbias": (
            "tim_tpu_torch/csrc/window_attention_dbias.cu",
            "tim_tpu/ops/pallas_swin.py:109", "heads-swin-a-train"),
        # replaces no TPU kernel (JAX leaves the bias add to XLA)
        "bias_act": ("tim_tpu_torch/csrc/bias_act.cu", None,
                     "extract-videomae"),
    }
    log(f"[time] {json.dumps(PHASE_S)}; total "
        f"{time.perf_counter() - T_START:.2f} s from the start of the script")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": by_path[path][name], "path": path,
         "launches_by_path": {p: counts[name] for p, counts in
                              by_path.items()},
         **measured(kernel_report[name])}
        for name, (src, rep, path) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:     # a rank of phase 24
        sys.exit(tp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    sys.exit(main())
