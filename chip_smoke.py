#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one GPU)
    python3 chip_smoke.py --phases env,kernel
    python3 chip_smoke.py --phases env,kernel,train
    python3 chip_smoke.py --phases env,kernel,train_kv
    python3 chip_smoke.py --phases env,kernel,train_fused
    python3 chip_smoke.py --phases env,kernel,train_adam
    python3 chip_smoke.py --phases env,train_sharded,time_train
    python3 chip_smoke.py --phases env,ndarray
    python3 chip_smoke.py --phases env,zoo
    python3 chip_smoke.py --phases env,train_amp
    python3 chip_smoke.py --phases env,train_rec,api
    python3 chip_smoke.py --phases env,train_jpeg,train_det
    python3 chip_smoke.py --phases env,train_module,train_symblock
    python3 chip_smoke.py --phases env,train_lm_deep
    python3 chip_smoke.py --phases env,kernel,train_lm
    python3 chip_smoke.py --phases env,kernel,serve_int8
    python3 chip_smoke.py --phases env,kernel_bn,time_bn
    python3 chip_smoke.py --phases env,train,time_train
    python3 chip_smoke.py --phases env,kernel_conv_fwd,time_conv_fwd
    python3 chip_smoke.py --phases env,kernel_conv_bwd,time_conv_bwd
    python3 chip_smoke.py --phases env,kernel_flash,time_flash
    python3 chip_smoke.py --phases env,train_lm,time_lm
    python3 chip_smoke.py --phases env,kernel_qmm,time_qmm
    python3 chip_smoke.py --phases env,serve_int8,time_int8
    python3 chip_smoke.py --phases env,kernel_codec,time_codec

Phases, each printing JSON lines:

1. env     -- card name and power limit, torch/CUDA versions, the nvcc
              build of every kernel source in mxnet_tpu_torch/csrc/ (one
              nvcc per source, all started together), and the image
              decoders the machine offers: whether PIL and cv2 import (in
              a child interpreter) and where libnvjpeg is.
2. kernel  -- each kernel against its plain PyTorch version on the card:
              conv_fused at the shapes ResNet-50 serving gives it (batch
              32) and at edge shapes, the bf16 forward also with the same
              bits on a second launch at the serving shapes and planned
              for a card of FEW_SMS SMs; the four training-BatchNorm kernels
              (stats, apply, bwd_reduce, bwd_dx) at the nine (R, C) shapes
              of ResNet-50 training at batch 128 and at edge shapes (a
              channel of zeros, a variance that clamps to 0, an inf); bf16
              and f32, relu on and off. BatchNorm forward outputs must be
              equal bit for bit, backward within 2e-4 of max |reference|;
              the two folds (stats, bwd_reduce) must give the same bits on
              a second launch, also at BN_SEVERAL_ITEMS (R = 64 * 25088 +
              17, and plans for a card of FEW_SMS SMs), where each
              persistent block walks several items.
              The conv_fused backward pair (d-input with its finalize
              launch, d-weight with its reduce launch) at the four fused
              shapes of ResNet-50 training at batch 128 and the edge
              shapes, bf16 and f32, relu on and off (BWD_RTOL), every
              output with the same bits on a second launch; both bf16
              kernels also planned for a card of FEW_SMS SMs so that each
              persistent block walks several work items. The packed
              SGD apply over ResNet-50's 161 trainable shapes, bf16 and
              f32, against its plain version and the per-parameter
              step_fn chain, bit for bit. The flash-attention forward, dQ
              and dK/dV kernels at the transformer LM's attention (H 32,
              S 2048, D 128, causal, bf16; batch cut to 1 so that the
              plain version's scores fit), contiguous and as the
              transposed [B, S, H, D] views the LM passes, and at edge
              shapes (non-causal, Sq != Sk, S = 100, 130 and 257, Sq
              129 against Sk 449, D = 64, B*H = 1) in bf16 and f32
              (FLASH_RTOL; bf16 outputs also row by row, FLASH_ROWWISE);
              a second launch must give the same bits. The int8 matmul
              (int32 and scaled forms) at every product shape int8
              ResNet-50 v1 gives it at batch 32 (read off the network; each
              on the wgmma route), at edge shapes of both routes (M, K or N
              of 1, odd sizes, K = 147, N = 1000, ragged tails of the wgmma
              tiles, M below 64, N % 4 != 0, split K) and planned for a
              card of FEW_SMS SMs, with w N-contiguous, x row-strided, 1
              byte off alignment (the byte route) and transposed (refused),
              and at int8 extremes: bit for bit, the same bits on a second
              launch, and the route the wrapper's predicate names. The
              flash and int8 launchers also as the first CUDA call of a
              new thread (they encode tensor maps). The 2-bit quantize and
              dequantize kernels at every compressed ResNet-50 parameter
              size and at edge sizes (CODEC_EDGE_N), bf16 and f32,
              thresholds 0.5 and 0.3, with exactly +-threshold, +-0.0,
              +-inf and NaN among the values, one tensor a call and in
              grouped calls (all 54 sizes, the edge sizes and a
              misaligned segment in one launch; 71 segments in two
              launches planned for FEW_SMS SMs): words, residuals and
              decoded values bit for bit, the same bits on a second
              launch. The
              packed Adam apply over ResNet-50's trainable shapes, bf16 and
              f32, with weight decay, with and without clip, at update
              counts 1 and 10: bit for bit against its plain version and
              the per-parameter step_fn chain.
3. serve   -- the serving path: resnet50_v1(layout="NHWC", fuse=True) in
              bf16 answers 4 requests of 32 images (top-5 classes each).
              Launch counters are zeroed just before and read just after;
              every fused link must have gone through its kernel. Logits
              are checked against the same weights run with fuse=False (no
              kernel), then once more in f32 with TF32 off, and against the
              port on the CPU for two images.
3b. serve_int8 -- int8 inference: resnet50_v1() (NCHW, f32) through
              contrib.quantization.quantize_net, naive calibration on 2
              batches of 32 (numpy seed 2), answers 4 requests of 32 and
              one batch of 256 (numpy seed 0). Counters are zeroed just
              before: the scaled int8 kernel must launch 54 times per
              forward, the int32 one never. Logits within 0.05 of the same
              network's f32 logits (TF32 off), relative to their max. Every
              product shape the kernel was given on that path (batch 256's
              too, M up to 3,211,264) is checked against the plain version
              bit for bit, with a second launch, unless phase kernel
              already checked it. Then
              two images against the port on the CPU under one carried
              int8 state (convert.quantized_state): the stem's codes and
              int32 sums bit for bit, the logits within INT8_CARD_CPU_RTOL;
              calibrated thresholds card vs CPU within
              INT8_THRESHOLD_RTOL. Then the nd.contrib op family
              (quantized_conv at each distinct convolution, and
              quantized_fully_connected 2048 -> 1000) at batch 32 against
              the CPU port on two images, bit for bit, one int32 kernel
              launch per call.
4. train   -- the training path: resnet50_v1(layout="NHWC", fuse=False) in
              bf16, batch 128, SoftmaxCrossEntropyLoss, autograd.record(),
              loss.backward(), gluon.Trainer SGD (lr 0.01, momentum 0.9),
              5 steps on one batch. Counters are zeroed just before: each
              BatchNorm kernel must launch 53 times per step (and the
              finalize launch twice per BatchNorm), conv_fused never; the
              loss must be finite and fall. Then one f32 step at batch 4,
              TF32 off, against the port on the CPU.
4b. train_kv -- phase train's step with a user-made kvstore attached:
              mx.kv.create("local") with 2-bit compression (threshold 0.5)
              given to gluon.Trainer, 5 steps. Every gradient is pushed
              (compressed when it has at least 4096 elements: 54 of the
              161 trainable parameters, 25,502,912 elements) and pulled
              back into param.grad(): the Trainer pushes and pulls all
              161 keys at once, so the store encodes the 54 with one
              grouped call of each codec kernel. Counters are zeroed just
              before: exactly 1 quantize and 1 dequantize launch per step,
              each of 54 segments, 53 per BatchNorm kernel, no conv_fused;
              the loss finite and falling. Then one more step with the pushes recorded: every
              compressed key's pulled gradient and residual equal the plain
              codec on the card on the same pushed gradient and residual,
              every other key's pulled gradient the pushed one, bit for
              bit. Then 2 steps (batch 16) with update_on_kvstore=True
              against 2 with False, fresh stores, same start: the weights
              equal bit for bit.
5. train_fused -- the fused training path: resnet50_v1(layout="NHWC",
              fuse=True), hybridized, in bf16, batch 128, through
              gluon.train_step with MXTPU_FUSED_APPLY=1 (SGD lr 0.01,
              momentum 0.9), 5 steps on one batch. Counters are zeroed
              just before: the conv_fused forward, d-input and d-weight
              kernels must launch 16 times per step, each BatchNorm kernel
              37 times (74 finalize launches), the packed apply once per
              bucket; every step "fused"; the loss finite and falling.
              Then one f32 step at batch 4, TF32 off, against the port on
              the CPU, and two bf16 steps with MXTPU_FUSED_APPLY=0 against
              two with =1 from the same weights: equal bit for bit.
5b. train_adam -- phase train_fused's step with Adam (lr 1e-3, wd 1e-4)
              in place of SGD: 5 steps, counters zeroed just before: one
              packed Adam launch per bucket per step, the conv_fused and
              BatchNorm counts of train_fused, every step "fused", the loss
              finite and falling. Then MXTPU_FUSED_APPLY 0 against 1 over
              two bf16 steps (equal bit for bit), and one eager f32
              Trainer.step with Adam, the card against the CPU (the bounds
              of train's f32 check).
5c. train_sharded -- bench.py's bench_resnet path: resnet50_v1(layout=
              "NHWC") in bf16, batch 128, through parallel.ShardedTrainStep
              (create_mesh(devices=[cuda:0], dp=1), data_parallel,
              SoftmaxCrossEntropyLoss, SGD lr 0.01 momentum 0.9), the batch
              placed once, 2 warm steps then 5: fuse=True ("sharded",
              BENCH_FUSED=pallas_all), fuse="auto" with
              remat_policy="conv_outs" ("sharded_remat", pallas_remat),
              and fuse="auto" without remat ("sharded_auto"). Counters
              are zeroed just before the 5 steps: exact launches of rows
              1-7 per step (_sharded_want: 16 fused links, or 3 under
              "auto"; under remat the backward's recompute runs each
              training BatchNorm's statistics and apply kernels again and
              no conv_fused forward); the loss finite and falling. Remat
              against "sharded_auto": lower peak memory over the 5 steps
              (both printed), and the same losses, weights and running
              statistics bit for bit after the 2 warm steps (cuDNN
              deterministic). Then two f32 steps of the narrow ResNet
              (fuse=True; fuse=False with remat), TF32 off, card against
              CPU (NARROW_RTOL), and all 17 registered optimizers (f32,
              and bf16 with multi_precision) through ShardedTrainStep,
              card against CPU (SHARDED_OPTIMIZERS, OPT_RTOL).
5d. ndarray -- the same ResNet-50 v1 NHWC bf16 (weights from numpy seed 0,
              data from seed 1) through the mx.nd front end. Serving: 4
              requests of mx.nd.array(x, ctx=mx.gpu(0), dtype="bfloat16"),
              batch 32, fuse=True: each answer an NDArray on gpu(0) with
              the bits of the same net called on the tensor, exactly 16
              conv_fused launches per forward (counters zeroed just
              before). Training: 2 eager steps (fuse=False, batch 128,
              bench_resnet's SGD) fed NDArray data and labels under
              autograd.record(), loss.backward(), trainer.step(128):
              exactly 53 launches of each BatchNorm kernel per step, every
              weight and running statistic equal bit for bit to 2
              tensor-fed steps from the same start (cuDNN deterministic).
              Checkpoint: save_parameters and save_states after step 2;
              the file's bytes equal nd.save of the same arrays moved to
              the CPU; a fresh net load_parameters(f, ctx=mx.gpu(0)) and a
              fresh Trainer load_states: the same weights, the same bits
              of a b32 forward, and after a third step on both the same
              weights. Then the save and load wall times, and host ms per
              eager step fed tensors and NDArrays in turns (tensor,
              NDArray, NDArray, tensor; 3 steps a turn).
5e. zoo    -- the vision model zoo (gluon.model_zoo.vision.get_model, random
              weights from numpy seed 0, 1000 classes). Serving: alexnet,
              vgg16_bn, densenet121, squeezenet1.1, inceptionv3 (299x299),
              mobilenet1.0, mobilenetv2_1.0 and resnet50_v2 at their
              published widths, each 2 requests of 32 images in f32 with
              TF32 off: finite (32, 1000) logits, the first 2 images'
              against the port on the CPU within ZOO_LOGIT_RTOL of their
              largest magnitude; the forward's device busy ms, wall ms,
              images/sec and idle share. Then rows 4-7 at ResNet-50 V2's
              input BatchNorm (C = 3, R = 128 x 224 x 224, bf16, the
              kernels' non-TMA route) against their plain versions.
              ResNet-50 V2 training: NHWC, bf16, batch 128, SGD lr 0.01
              momentum 0.9, 5 steps through gluon.train_step with
              MXTPU_FUSED_APPLY=1. Counters are zeroed just before: rows 4
              and 5 launch 51 times per step (every BatchNorm), rows 6 and
              7 50 times (not the image's, which has nothing to
              differentiate), each fold its finalize launch, the packed
              apply once per bucket, conv_fused never; every step
              "fused", no fallback; the loss finite and falling; then
              images/sec, device busy ms, idle share and peak memory, and
              one f32 step of a narrow V2, card against CPU
              (NARROW_RTOL). VGG-16 training: bf16 NCHW, batch 64, 3 eager
              Trainer steps with both Dropouts active: the loss finite,
              each Dropout's keep share within 6 standard errors of 0.5
              and every kept value x / 0.5 exactly, and the same masks
              bit for bit twice under one mx.random.seed. DenseNet-121
              training: bf16 NCHW, batch 64, 3 eager steps, the loss
              falling (average pooling and concatenation backward at
              full width).
5b. train_amp -- ResNet-50 v1 (layout="NHWC", fuse=False) with float32
              parameters (numpy seed 0) trained under contrib.amp.init()
              (bfloat16) from a gluon.data pipeline: an ArrayDataset of
              1280 synthetic uint8 HWC 224x224x3 images with int labels of
              (numpy seed AMP_DATA_SEED), transform_first(Compose([
              RandomFlipLeftRight(), Cast("float32")])), a DataLoader
              (batch 128, shuffle, last_batch "discard", 4 worker threads,
              pin_memory); each batch through gluon.utils.split_and_load,
              made NCHW, then autograd.record, amp.scale_loss,
              SoftmaxCrossEntropyLoss, Trainer.step (SGD lr 0.01, momentum
              0.9, amp.init_trainer's loss scaler), metric.Accuracy and
              callback.Speedometer(frequent=5). Counters are zeroed just
              before the 10 steps (one epoch): rows 4-7 launch 53 times per
              step in float32 (each fold its finalize launch), the packed
              apply and conv_fused never; no step skipped; the loss finite
              and falling (the last 3 steps' mean below the first 3's,
              each on a new batch); every metric.update() under
              torch.cuda.set_sync_debug_mode("error"). Then one step
              recording each op's dtypes (every Convolution and the
              FullyConnected bfloat16, every BatchNorm float32, as JAX's
              hook gives them); a step with an inf gradient leaves every
              weight and momentum bit for bit and halves the scale;
              gluon.train_step runs "fallback:amp-loss-scaler"; wall and
              device busy ms per step, idle share, peak memory; and the
              narrow NHWC ResNet's AMP step, card against the port on the
              CPU (AMP_NARROW_*).
5f. train_rec -- bench.py's bench_input_pipeline path on the port: 2048
              raw-pixel records of 256 x 256 x 3 uint8 (numpy seed 0,
              labels i % 10; ~403 MB) written with recordio's
              MXIndexedRecordIO into a temporary directory (deleted at
              the end); ImageRecordIter (3 x 224 x 224, batch 128,
              shuffle, rand_crop, rand_mirror, uint8, min(8, cores)
              threads) through DevicePrefetchIter onto gpu(0); ResNet-50
              v1 NHWC bf16, Xavier(gaussian, in, magnitude 2), through
              ShardedTrainStep in the `sharded` configuration (fuse=True,
              SGD momentum 0.9) at lr 1e-3 (REC_SGD says why); each batch
              normalised on the card
              as bench.py does ((x - mean) * 1/58 in bf16). Two epochs of
              16 steps, counters zeroed just before: 16 launches of rows
              1-3 and 37 of rows 4-7 per step. Checks: each epoch yields
              every record once in the order of a second iterator on the
              host (its orders, and each batch's labels and strided pixel
              sums), epoch 2's order not epoch 1's; the first two batches
              on the card equal the host's byte for byte; the first fed
              step's loss equals, bit for bit, a resident step's (a second
              ShardedTrainStep from the same weights) on the host's first
              batch, cuDNN deterministic; the loss finite and epoch 2's
              mean more than REC_LOSS_DROP below epoch 1's. Then the
              iterator's own images/sec (two epochs on the host), the
              host-to-card MB/s of one batch from pinned memory, fed and
              resident wall ms per step, device busy ms and idle share
              of both, and the peak memory.
5f'. train_jpeg -- train_rec's recipe on JPEG records: the same 2048
              images written with recordio.pack_img(..., quality=90,
              img_fmt=".jpg") as bench.py's _synth_rec writes them, and
              decoded by cv2 in ImageRecordIter's threads; the same
              launches, orders, bytes and loss checks. It prints the
              iterator's images/sec on JPEG beside train_rec's raw figure
              from the same run.
5f''. train_det -- example/ssd/train_ssd.py's detection path at its own
              width, on the card: the JPEG .rec of 64 synthetic-square
              images (ssd_make_rec_dataset), ImageDetIter with random
              crop, pad and flip (ssd_det_iter), TinySSD, MultiBoxPrior
              and MultiBoxTarget, softmax CE plus smooth-L1, SGD lr 0.1
              momentum 0.9 for 12 epochs: the last epoch's loss under
              0.7 x the first's (the example's own check). Then
              ssd_detect (MultiBoxDetection, NMS 0.45) on two held-out
              images, its shape and rows checked and held to the same
              call on the CPU with the trained weights (DET_RTOL); the top
              detection's IoU with the square is printed. Then the box
              ops at SSD300-on-VOC scale (8,732 anchors from maps 38, 19,
              10, 5, 3, 1 with 4, 6, 6, 6, 4, 4 anchors per location; 21
              classes, batch 32, up to 16 ground-truth rows):
              MultiBoxPrior, MultiBoxTarget and MultiBoxDetection on the
              card against the port on the CPU, each run once under
              torch.cuda.set_sync_debug_mode("error") (no host
              synchronisation at all), with device ms; the box_nms kernel
              against its plain version there, bit for bit, and timed
              beside its bound. Then every other new op of ops/image.py,
              ops/extended.py and ops/detection.py once on the card
              against the CPU (DET_OP_CASES). TinySSD's convolutions are
              cuDNN's: the phase launches no kernel of rows 1-15; its
              only hand-written kernel is box_nms.
5g. api    -- the M3b names on the card, each against the port on the
              CPU on the same inputs: every new loss's value and input
              gradients in f32 (CTCLoss with and without lengths), an
              autograd.Function with its own backward, foreach,
              while_loop and cond with gradients (API_RTOL, API_CTC_RTOL);
              a gluon.Constant left unchanged by Trainer.step;
              Context.empty_cache lowering torch.cuda.memory_reserved;
              nd.zeros(dtype=np.float16, ctx=mx.gpu(0)).
5h. train_module -- the Module path of MXNet's classic train_imagenet:
              resnet50_v1() (NCHW, f32) traced with mx.sym.var("data")
              under SoftmaxOutput (163 arguments, 106 aux states),
              Module(context=mx.gpu(0)).fit over an NDArrayIter of train's
              batch (128 images, numpy seed 1), 8 epochs of that one
              batch: SGD momentum 0.9 at lr 1e-3, Xavier(gaussian, in, 2),
              kvstore "local" (one device: no store), eval_metric "acc",
              do_checkpoint every 4 epochs. Every kernel counter is zeroed
              just before fit and must read 0 after it: NCHW BatchNorm runs
              the plain tree, as the JAX package's does. The loss per step
              (-mean log p of the label, read off the outputs) must fall.
              Then the first step's forward (the initial parameters, the
              batch's first 8 images, training mode) card against the port
              on the CPU, f32 with TF32 off (MODULE_FWD_RTOL); the last
              checkpoint through model.load_checkpoint, Module.score, and
              Predictor on the symbol JSON and the raw .params bytes at
              batch 32 against Module.predict on the same images
              (PREDICT_ATOL); device busy and wall ms per Module step.
5i. train_symblock -- the deployment round trip, fine-tuned: train's net
              (resnet50_v1 NHWC, numpy seed 0, bf16, fuse=False) traced
              and saved with Symbol.save, its parameters exported,
              gluon.SymbolBlock.imports(..., ctx=mx.gpu(0)), cast to bf16,
              3 gluon.Trainer steps (train's SGD) with
              SoftmaxCrossEntropyLoss under autograd.record on train's
              batch. Counters are zeroed just before: each of rows 4-7
              launches 53 times per step (each fold its finalize launch
              too), conv_fused never; the loss finite and falling. The
              first step's loss and updated parameters and running
              statistics against the zoo net's own eager step from the
              same parameters and batch, cuDNN deterministic, within
              RTOL["bfloat16"] (the same bits printed); then device busy ms
              per step of the SymbolBlock and of the zoo net's eager step
              (phase train's), in turns.
6. train_lm -- the transformer LM of bench.py's bench_transformer at its
              full width (dim 4096, 5 layers, 32 heads of 128, FFN 16384,
              vocab 32000, bf16, chunked CE over 8 chunks, full per-layer
              recompute; 1.6B parameters, random weights from seed 0):
              parallel.transformer.make_train_step, 5 SGD-momentum steps
              on one batch of 12 x 2048 tokens from numpy seed 0. Counters
              are zeroed just before: 10 forward, 5 dQ and 5 dK/dV flash
              launches per step; the loss finite and falling; the peak
              memory printed. Then one f32 step of a narrow LM (dim 512,
              2 layers, S 256), TF32 off, the card against the port on
              the CPU (LM_NARROW_RTOL), with the CPU in f64 beside both.
6b. train_lm_deep -- bench.py's deep LM config (24 layers, dim 2048, 16
              heads of 128, FFN 8192, vocab 32000, bf16, batch 8 x 2048,
              chunked CE over 8 chunks, full per-layer recompute; 1.74B
              parameters, random weights from seed 0). First rows 9-11 at
              its attention (batch cut to 1, the transposed [B, S, H, D]
              views) against their plain versions (FLASH_RTOL). Then 3
              SGD-momentum steps on one batch with remat_save=() and 3
              with ("attn_o",), counters zeroed before each: 48 forward,
              24 dQ and 24 dK/dV flash launches per step, then 24, 24, 24
              (the kept attention output spares the recompute's forward);
              the loss finite and falling; per run the peak memory, wall
              and device busy ms per step, idle share, tokens/sec and model
              TFLOP/s. Then one f32 step of the narrow LM with
              attn_mode="blockwise", TF32 off, card against CPU
              (LM_NARROW_RTOL).
7. time    -- CUDA-event times per kernel and shape (kernel, plain version,
              PyTorch library yardstick) beside the card's bound;
              whole-forward images/sec at batch 32 and 256 and both
              training steps' images/sec at batch 128, in bf16, with the
              device's busy time and idle share from the profiler; the
              flash kernels at the LM's attention (batch 12) beside
              scaled_dot_product_attention; the LM step's tokens/sec,
              device busy time, idle share, model TFLOP/s and mfu; the
              int8 matmul at every int8 ResNet-50 product shape beside
              torch._int_mm (cuBLASLt) and its bound; the int8 forward's
              images/sec at batch 32 and 256, device busy ms, idle share
              and device ms split into kernels, im2col, quantize passes
              and float layers, beside the f32 forward (TF32 off and
              on); the 2-bit codec kernels over one train_kv step's 54
              compressed gradients (one grouped launch of each; per size
              alone), the store's push and pull host ms, and the packed
              Adam kernel over one
              update phase, beside their bounds and plain versions (and
              torch._fused_adam_ for Adam); train_kv's and train_adam's
              images/sec, device busy time and idle share beside train's
              and train_fused's.

--phases may also name kernel_bn and time_bn, the four BatchNorm kernels'
part of phases kernel and time (rows 4-7: their checks, then per training
shape each kernel's per-launch time, plain and library times and share of
bound, with the folds' fold_plan; they need no other phase, so copy this
chip_smoke.py into a parent tree to time the two in turns), time_train,
the training steps' part of phase time (images/sec, device busy ms and idle
share of each train phase run before it, e.g. --phases env,train,time_train
or env,train_sharded,time_train),
kernel_conv_fwd and time_conv_fwd, the conv_fused
forward's part of phases kernel and time (row 1: its checks, then per
serving shape the kernel, the library call, cuDNN's convolution alone, the
bound and fwd_plan's nb and items; it needs no other phase, so copy this
chip_smoke.py into a parent tree to time the two in turns), kernel_conv_bwd
and time_conv_bwd, the conv_fused backward pair's part, and kernel_flash and
time_flash, the flash kernels' part (rows 9-11; time_flash also times the
three bf16 kernels on the LM's [B, S, H, D] buffers seen transposed, the
bf16 forward at head dim 64 and the f32 forward), to run them alone after
env, time_lm, the LM step's timing, after env,train_lm, and kernel_qmm
and time_qmm, the int8 matmul's part (rows 12-13: its checks, including
the wgmma route's edge shapes and a FEW_SMS-SM plan, and its times per
shape beside torch._int_mm, the bound and the route taken), after env
alone, time_int8, int8 serving's part of phase time (time_qmm, then
the int8 and float32 forwards' images/sec), after env,serve_int8, and
kernel_codec and time_codec, the 2-bit codec's part (rows 14-15: its
checks; its times per step and per size and the store's push and pull
host ms; time_codec needs no other phase and times a tree without the
grouped calls in its per-tensor form, so copy this chip_smoke.py into a
parent tree to time the two in turns) (the default run does not name
them: phases kernel and time run them).

The run ends with the nvidia-smi name/power line, then the
{"kernels": [...]} line (per kernel: launches on its path (rows 1-7 also
on train_sharded's, per configuration; rows 4-8 also on zoo's ResNet-50 V2
training, launches_zoo; rows 4-7 on train_amp's, launches_train_amp; rows
1-7 on train_rec's, launches_train_rec, and on train_jpeg's,
launches_train_jpeg; rows 1 and 4-7 on train_symblock's,
launches_train_symblock; every kernel 0 on train_module's,
launches_train_module; box_nms on train_det's; rows
9-11 on train_lm_deep's, per remat_save, launches_train_lm_deep), max abs
error at
the ResNet-50 shapes in bf16 and its tolerance, and the times, bound,
plain and library times of one forward (conv_fused; the int8 forward at
batch 32 for the scaled int8 matmul) or one training step (the other
kernels; the LM step for flash attention), or one pass of the nd.contrib
op family (the int32 int8 matmul)), then {"ok": true, "device": {...}} as
the last line. Any failure exits non-zero before them.
Weights and data are drawn from fixed seeds; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

PHASES = ("env", "kernel", "serve", "serve_int8", "train", "train_kv",
          "train_fused", "train_adam", "train_sharded", "ndarray", "zoo",
          "train_amp", "train_rec", "train_jpeg", "train_det", "api",
          "train_module", "train_symblock", "train_lm", "train_lm_deep",
          "time")
# Parts of "kernel" and "time" that --phases can name alone (after env):
# the BatchNorm kernels' checks and timing, the training steps' timing
# (after the train phases), the conv_fused forward's, the backward pair's,
# the flash kernels',
# the LM step's timing (after train_lm), the int8 matmul's checks and
# timing, int8 serving's timing (after serve_int8), and the 2-bit codec's
# checks and timing.
SUB_PHASES = ("kernel_bn", "time_bn", "time_train", "kernel_conv_fwd",
              "time_conv_fwd", "kernel_conv_bwd",
              "time_conv_bwd", "kernel_flash", "time_flash", "time_lm",
              "kernel_qmm", "time_qmm", "time_int8", "kernel_codec",
              "time_codec")

# ResNet-50's fused 3x3 links at batch 32: (N, H, W, Ci, Co) and how many
# of the 16 launches per forward run at that shape.
RN50_SHAPES = [((32, 56, 56, 64, 64), 3), ((32, 28, 28, 128, 128), 4),
               ((32, 14, 14, 256, 256), 6), ((32, 7, 7, 512, 512), 3)]
# Ragged tiles (H, W not multiples of the 16x8 tile), channel counts that
# are not multiples of the 32-channel chunk or the 64-channel block, an odd
# Co, a Ci below the 8-wide vector loads, relu off.
EDGE_SHAPES = [((3, 8, 8, 16, 24), True), ((2, 7, 7, 24, 40), True),
               ((5, 9, 13, 24, 40), False), ((1, 1, 1, 8, 8), True),
               ((3, 17, 9, 32, 72), False), ((2, 5, 3, 3, 5), True),
               ((4, 15, 17, 40, 129), True)]
# How the bf16 forward kernel is built (csrc/conv_fused.cu).
CONV_FWD_DESIGN = ("redesigned for Hopper: persistent blocks over fwd_plan's "
                   "items, a TMA ring of x halos activated in place and of "
                   "weight boxes, wgmma, a TMA-stored epilogue")

# Tolerances, relative to the largest |reference| value of the case:
# bf16 -- one bf16 rounding step at the output's magnitude (2^-6 ~ 1.6e-2
#         covers the last-bit differences of two f32 accumulation orders);
# f32  -- summation order only (the kernel and cuDNN with TF32 off both
#         keep full f32 products).
RTOL = {"bfloat16": 1.6e-2, "float32": 1e-4}
# Whole-network logits, fused vs unfused, relative to max |logit|: bf16
# rounds the activation at different points in the two paths through 16
# blocks; f32 differs by summation order only.
LOGIT_RTOL = {"bfloat16": 3e-2, "float32": 1e-4}

# ResNet-50's 53 BatchNorms in training at batch 128: the (N, H, W, C) of
# each input (R = N*H*W rows of C channels) and how many run at that shape.
BN_SHAPES = [((128, 112, 112, 64), 1), ((128, 56, 56, 64), 6),
             ((128, 56, 56, 256), 4), ((128, 28, 28, 128), 8),
             ((128, 28, 28, 512), 5), ((128, 14, 14, 256), 12),
             ((128, 14, 14, 1024), 7), ((128, 7, 7, 512), 6),
             ((128, 7, 7, 2048), 4)]
BN_PER_STEP = sum(n for _, n in BN_SHAPES)       # 53
BN_EDGE_R = (1, 63, 65, 4097)
# 3, 5, 129 and 2049 channels take the folds' plain-load route (a row pitch
# TMA cannot describe); 24 and 72 the TMA route with a part-filled slab.
BN_EDGE_C = (3, 5, 24, 72, 129, 2049)
BN_EPS = 1e-5                   # gluon.nn.BatchNorm's default epsilon
# Backward tolerance of the BatchNorm kernels against their plain
# versions, relative to max |reference| (the JAX suite's own bound for its
# kernel); the forward is held bit for bit.
BN_BWD_RTOL = 2e-4
BN_KERNELS = ("stats", "apply", "bwd_reduce", "bwd_dx")
# Line of each TPU kernel body in mxnet_tpu/pallas_kernels/batchnorm_fused.py.
BN_REPLACES = {"stats": 208, "apply": 219, "bwd_reduce": 230, "bwd_dx": 250}
# f32 operations per element of each BatchNorm kernel (sum and
# exact_sq's split; exact_mul's split; xhat and dy'*xhat; xhat and the dx
# chain): all far below the bytes they move.
BN_OPS = {"stats": 9, "apply": 11, "bwd_reduce": 5, "bwd_dx": 6}
# Training-step checks, f32 with TF32 off, card against the port on the CPU
# (relative to the largest magnitude of the compared tensor). The gradient
# and weight bounds widen to twice the spread between two other correct f32
# runs (_f32_card_vs_cpu says which, and why).
TRAIN_RTOL = {"loss": 1e-5, "grad": 1e-3, "param": 1e-5}

# ResNet-50's 16 fused links in training at batch 128 (the serving shapes
# at batch 128), and the 37 BatchNorms that a fuse=True net keeps.
RN50_TRAIN_SHAPES = [((128,) + shape[1:], n) for shape, n in RN50_SHAPES]
FUSED_PER_STEP = sum(n for _, n in RN50_SHAPES)                 # 16
BN_FUSED_NET_PER_STEP = BN_PER_STEP - FUSED_PER_STEP            # 37
# The conv_fused backward pair against its plain version, relative to max
# |reference|: bf16 outputs one bf16 rounding step, as the forward; f32 dx
# differs by summation order only; f32 dw, ds and db are sums over up to
# 401408 pixels.
BWD_RTOL = {"bfloat16": {"dx": 1.6e-2, "ds": 1.6e-2, "db": 1.6e-2,
                         "dw": 1.6e-2},
            "float32": {"dx": 1e-4, "ds": 1e-3, "db": 1e-3, "dw": 1e-3}}
# The bf16 d-input and d-weight kernels planned for a card of FEW_SMS SMs,
# so that each persistent block walks several work items (on 132 SMs the
# d-weight kernel plans one item per block at every training shape, the
# d-input kernel one at 7x7).
FEW_SMS = 5
FEW_SMS_CASES = [((8, 28, 28, 128, 128), True), ((8, 7, 7, 512, 512), False),
                 ((4, 15, 17, 40, 129), False)]
# The two BatchNorm folds where each persistent block walks several items:
# (R, C, dtype, act, SMs, None for the card's own): a row count that is not
# a multiple of 64, with 16 blocks per warp and item; training shapes
# planned for FEW_SMS SMs; both routes.
BN_SEVERAL_ITEMS = [(64 * 25088 + 17, 64, "bfloat16", None, None),
                    (64 * 25088 + 17, 64, "float32", "relu", None),
                    (401408, 256, "bfloat16", "relu", FEW_SMS),
                    (100352, 128, "float32", None, FEW_SMS),
                    (6272, 2048, "bfloat16", None, FEW_SMS),
                    (4097, 72, "bfloat16", "relu", FEW_SMS),
                    (4097, 129, "float32", "relu", FEW_SMS)]
# How the two folds are built (csrc/batchnorm_fused.cu).
BN_FOLD_DESIGN = ("redesigned for Hopper: persistent blocks over fold_plan's "
                  "items, a TMA ring of 64-row boxes per warp, the JAX tree "
                  "folded from shared memory (+ the finalize launch)")
# The two backward kernels: their outputs, the names of their launches in
# the profiler (kernel and second pass) and the line of the TPU kernel body
# in mxnet_tpu/pallas_kernels/conv_fused.py.
BWD_OUTS = ("dx", "ds", "db", "dw")
CONV_BWD = {"bwd_dx": (("dx", "ds", "db"), ("conv_bwd_dx_",
                                            "conv_bwd_finalize"), 135),
            "bwd_dw": (("dw",), ("conv_bwd_dw_", "conv_dw_reduce"), 185)}
# How each bf16 backward kernel is built (csrc/conv_fused.cu).
CONV_BWD_DESIGN = {
    "bwd_dx": "redesigned for Hopper: persistent blocks over dx_plan's "
              "items, a TMA ring of dy halo rows and weight boxes, wgmma",
    "bwd_dw": "redesigned for Hopper: persistent blocks over dw_plan's "
              "items, a TMA ring of halo and dy rows, wgmma"}
# The training steps: SGD as bench.py's bench_resnet sets it.
SGD = {"learning_rate": 0.01, "momentum": 0.9}
# f32 operations per element of the packed SGD step (rescale, wd*w, +g,
# *lr, momentum*m, -, +w): far below the bytes it moves.
APPLY_OPS = 7
# Adam in the fused step (phase train_adam): the JAX default learning rate
# with weight decay. f32 operations per element of its packed step
# (rescale, wd*w, +, b1*m, (1-b1)*g, +, (1-b2)*g, *g, b2*v, +, sqrt, +eps,
# lr*m, /, -): far below the 14 bytes (bf16) it moves.
ADAM = {"learning_rate": 1e-3, "wd": 1e-4}
ADAM_OPS = 15

# The sharded training step (phase train_sharded): bench.py's bench_resnet
# through parallel.ShardedTrainStep on a one-device mesh, in the two
# configurations BENCH_FUSED names, and fuse="auto" without remat as the
# baseline of remat's memory, launches and bits. fuse="auto" fuses the
# bottlenecks whose 3x3 is at least 512 wide: stage 4's three.
SHARDED = {"sharded": (True, None),             # BENCH_FUSED=pallas_all
           "sharded_remat": ("auto", "conv_outs"),    # pallas_remat
           "sharded_auto": ("auto", None)}
SHARDED_AUTO_FUSED = 3
# The narrow NHWC ResNet of tests/test_torch_train.py (f32, batch 4 of
# 32x32, weights from numpy seed 3), card against CPU, within the bounds
# of its test_narrow_resnet_trains_like_jax: the loss 1e-5 relative, every
# parameter and running statistic 1e-5 of its largest magnitude.
NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
NARROW_RTOL = {"loss": 1e-5, "param": 1e-5}
# Every registered optimizer (Test aside) through ShardedTrainStep, card
# against CPU: a Dense(16 -> 8) at batch 1 under the linear loss
# sum(out * y), so that both devices get the same gradients bit for bit
# (every product exact, no sum) and only the optimizers' arithmetic can
# differ; 3 steps, each on its own batch. f32 weights, and bf16 weights
# with multi_precision. Every f32 tensor (weights, masters, states) within
# OPT_RTOL of its largest magnitude: a CUDA division by a Python scalar
# multiplies by its reciprocal and norms sum in another order, a few ulps;
# bf16 weights within one bf16 ulp of their largest magnitude.
SHARDED_OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-3, clip_gradient=2.0),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd=1e-3, wd_lh=1e-3),
    "ftml": dict(learning_rate=0.05, wd=1e-3),
    "lars": dict(learning_rate=0.1, momentum=0.9, lars_eta=0.01,
                 lars_epsilon=1e-8, wd=1e-3),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9, batch_scale=4,
                  warmup_epochs=1, updates_per_epoch=8),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
    "sgld": dict(learning_rate=0.01, wd=1e-3),
    "adam": dict(learning_rate=0.01, wd=1e-3, clip_gradient=2.0),
    "adamw": dict(learning_rate=0.01, wd=1e-3),
    "adagrad": dict(learning_rate=0.1, wd=1e-3),
    "adadelta": dict(wd=1e-3),
    "rmsprop": dict(learning_rate=0.01, centered=True, clip_weights=1.5),
    "adamax": dict(learning_rate=0.01, wd=1e-3),
    "nadam": dict(learning_rate=0.01, wd=1e-3),
    "ftrl": dict(learning_rate=0.1, lamda1=0.05, wd=1e-3),
    "nag": dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
    "lamb": dict(learning_rate=0.01, wd=1e-3, lower_bound=0.1,
                 upper_bound=5.0),
}
OPT_RTOL = 1e-5
OPT_BF16_RTOL = 2.0 ** -8

# The compressed kvstore (phase train_kv): 2-bit compression at the
# reference's default threshold. A pushed gradient is compressed when it
# has at least size_lower_bound elements (MXNET_KVSTORE_SIZE_LOWER_BOUND,
# 4096): in ResNet-50 v1 the 53 convolution weights (the smallest, 64 x 64
# x 1 x 1, sits at the bound) and the classifier's weight, 25,502,912
# elements of the 161 trainable parameters; the 106 BatchNorm gammas and
# betas and the classifier's bias pass uncompressed.
KV_COMPRESSION = {"type": "2bit", "threshold": 0.5}
KV_BOUND = 4096
KV_TRAINABLE = 161
KV_COMPRESSED = 54
KV_COMPRESSED_ELEMENTS = 25502912
# The codec kernels (rows 14-15) are checked at every compressed
# ResNet-50 size and at these edge sizes (within and around one 16-value
# word and the size bound, and a large odd size), at both thresholds, bit
# for bit. Line of each TPU kernel body in
# mxnet_tpu/pallas_kernels/compression.py.
CODEC_EDGE_N = (1, 15, 16, 17, 4095, 4096, 4097, 100003)
CODEC_THRESHOLDS = (0.5, 0.3)
CODEC_REPLACES = {"quantize": 70, "dequantize": 82}

# The transformer LM of bench.py's bench_transformer at its on-chip
# defaults (bench.py:87-96,155-165): 1.6B parameters, bf16, batch 12 of
# 2048 tokens, chunked CE over 8 chunks, full per-layer recompute.
LM_CFG = dict(vocab_size=32000, dim=4096, n_layers=5, n_heads=32,
              ffn_hidden=16384, max_seq_len=2048, dtype="bfloat16",
              attn_mode="local", loss_chunks=8, remat=True, remat_save=())
LM_BATCH, LM_SEQ = 12, 2048
# The smoke run's SGD-momentum learning rate: large enough that 5 steps on
# one batch move the bf16 weights (at the JAX default 1e-3 most updates
# stay below one bf16 step of the weight, and the loss barely moves).
LM_LR = 0.1
# Flash kernels per LM step: the forward twice per layer (once more in the
# layer's recompute), the backward pair once per layer.
FLASH_PER_STEP = {"fwd": 2 * LM_CFG["n_layers"], "dq": LM_CFG["n_layers"],
                  "dkv": LM_CFG["n_layers"]}
# Line of each TPU kernel body in mxnet_tpu/pallas_kernels/flash_attention.py.
FLASH_REPLACES = {"fwd": 105, "dq": 249, "dkv": 280}
FLASH_OUTS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
FLASH_DESIGN = {
    "fwd": "redesigned for Hopper: 128-row query tiles, a TMA ring of K and "
           "V tiles, wgmma, pingpong warpgroups",
    "dq": "redesigned for Hopper: 128-row query blocks, a TMA ring of "
          "128-key K and V tiles, wgmma, pingpong warpgroups",
    "dkv": "redesigned for Hopper: 128-key blocks, a TMA ring of Q and dO "
           "tiles, wgmma, pingpong warpgroups"}
# Flash kernels against their plain versions, relative to max |reference|:
# bf16 outputs one bf16 rounding step (as conv_fused); lse is f32 from f32
# scores that differ by summation order only; f32 o/lse 1e-5 and gradients
# 1e-4, the JAX suite's own bounds (tests/test_pallas.py:30,47).
FLASH_RTOL = {"bfloat16": {"o": 1.6e-2, "lse": 1e-5, "dq": 1.6e-2,
                           "dk": 1.6e-2, "dv": 1.6e-2},
              "float32": {"o": 1e-5, "lse": 1e-5, "dq": 1e-4, "dk": 1e-4,
                          "dv": 1e-4}}
# (B, H, Sq, Sk, D, causal): the LM's attention with the batch cut from 12
# to 1, so that the plain version's [B, H, S, S] f32 scores fit; and the
# edge shapes: non-causal, Sq != Sk, ragged tiles (S = 100, 257; Sq 129
# and Sk 449 against the dK/dV kernel's 64-row q tiles and 128-key
# blocks; causal S = 130, whose last 128-row query block holds two rows,
# so that the dQ kernel's second warpgroup holds none), D = 64, B*H = 1;
# each in bf16 and f32.
FLASH_MAIN = (1, 32, 2048, 2048, 128, True)
# The bf16 outputs are also held row by row: each row of o and dq (a query
# row) and of dk and dv (a key row) within FLASH_RTOL of that row's own max
# |reference|, so that late causal rows, whose values lie far below the
# tensor's max, are held to their own bf16 step. A row whose max is below
# FLASH_ROW_FLOOR of the tensor's max is measured against that floor: such
# a row is the f32 residue of a cancellation (causal query row 0 of dq,
# where P = 1 and dP - delta is zero but for summation order), and two
# summation orders leave different residues.
FLASH_ROW_FLOOR = 2.0 ** -12
FLASH_ROWWISE = ("o", "dq", "dk", "dv")
# Layouts the flash kernels are checked in at FLASH_MAIN: "bhsd" contiguous
# [B, H, S, D], and "bshd", [B, S, H, D] buffers seen transposed to
# [B, H, S, D], as the LM's attention passes its projections.
FLASH_LAYOUTS = ("bhsd", "bshd")
FLASH_EDGE = [(2, 4, 256, 256, 128, False), (2, 2, 128, 384, 64, False),
              (2, 3, 100, 100, 128, True), (1, 2, 257, 257, 64, True),
              (1, 1, 384, 384, 128, True), (1, 2, 100, 257, 128, False),
              (1, 3, 129, 449, 64, False), (1, 2, 130, 130, 128, True)]
# The narrow f32 LM of the card-vs-CPU step (TF32 off), and its bounds
# relative to each tensor's max: both sides keep f32 products (the card's
# f32 flash kernels run on the CUDA cores, cuBLAS without TF32), so they
# differ by summation order through two layers. Gradients are read as the
# first step's momentum (m = 0.9*0 + g).
LM_NARROW = dict(vocab_size=1024, dim=512, n_layers=2, n_heads=4,
                 ffn_hidden=1376, dtype="float32", loss_chunks=2)
LM_NARROW_BATCH, LM_NARROW_SEQ = 2, 256
LM_NARROW_RTOL = {"loss": 1e-5, "grad": 1e-4, "param": 1e-5}

# Int8 inference (phase serve_int8): resnet50_v1() NCHW, float32, with the
# weights of numpy seed 0, through contrib.quantization.quantize_net (naive
# calibration on 2 batches of 32 from numpy seed 2): its 53 convolutions and
# the classifier become int8 layers, one launch of the scaled int8 kernel
# each per forward. Line of each TPU kernel body in
# mxnet_tpu/pallas_kernels/quantized_matmul.py.
QMM_REPLACES = {"mm": 79, "mm_scaled": 95}
QMM_DESIGN = ("redesigned for Hopper: persistent blocks over qmm_plan's "
              "tiles, a TMA ring, s8 wgmma, split K where tiles are few, a "
              "TMA-stored epilogue; a byte route (mma.sync) for operands TMA "
              "cannot describe")
INT8_LAYERS = 54
INT8_BATCH = 32
INT8_CALIB = 2
# int8 logits against the same network's float32 logits (TF32 off),
# relative to max |reference|: the JAX suite's own bound for quantize_net
# (tests/test_contrib.py:115,127).
INT8_LOGIT_RTOL = 0.05
# The card against the port on the CPU under one carried int8 state (two
# images), relative to max |CPU logit|. The int8 products are exact on both;
# only where a float activation between the int8 layers differs in its last
# bits (BatchNorm's rsqrt, reduction order) can a value on a rounding
# boundary take the neighbouring code. Quantization itself moves every code
# by up to half a step and the logits by ~0.02 of their max (bound 0.05); a
# +-1 flip of a few codes among each layer's 1e5-1e6 moves them far less.
# The bound is a tenth of the quantization bound.
INT8_CARD_CPU_RTOL = 5e-3
# Calibrated thresholds (each layer's max |input|), card against CPU,
# relative: the float32 forward's own card-vs-CPU bound (LOGIT_RTOL).
INT8_THRESHOLD_RTOL = 1e-4
# Edge shapes (M, K, N) of the int8 kernel: M, K or N of 1; odd sizes; K =
# 147 (the stem's K before im2col pads it: the byte path); N = 1000; K not
# a multiple of the 64-byte tile.
QMM_EDGE = [(1, 64, 64), (64, 1, 64), (64, 64, 1), (1, 1, 1), (37, 33, 29),
            (129, 147, 1000), (33, 147, 64), (255, 2047, 17), (5, 16, 1000),
            (1000, 160, 3)]
# Edge shapes of the wgmma route (aligned operands): ragged M, N and K
# tails against its 128-row tiles, 64- and 128-column tiles and 128-byte K
# blocks; M below the 64-row wgmma tile; N = 1000; N % 4 != 0 (guarded
# stores in place of the TMA store); deep K split across blocks.
QMM_WGMMA_EDGE = [(130, 4608, 72), (1605, 4624, 520), (257, 1040, 260),
                  (31, 96, 1000), (32, 2048, 1000), (100, 48, 30),
                  (200, 4608, 38), (129, 64, 64)]
# The wgmma route planned for a card of FEW_SMS SMs, so that each
# persistent block walks several items (split tiles among them).
QMM_FEW_SMS = [(1568, 4608, 512), (130, 4608, 72), (1605, 4624, 520),
               (100352, 64, 64), (257, 4608, 200), (257, 9216, 72)]
# Dense int8 tensor-core operations/s from NVIDIA's data sheets (twice the
# bf16 rate), keyed like PEAKS.
INT8_PEAKS = {"H100 PCIe": 1513e12, "H100 NVL": 1671e12, "H200": 1979e12,
              "H100": 1979e12}

# Dense peaks from NVIDIA's data sheets: (bf16 tensor FLOP/s, f32 FLOP/s
# on the CUDA cores, memory bytes/s), matched on the name nvidia-smi gives.
PEAKS = [("H100 PCIe", (756e12, 51e12, 2.0e12)),
         ("H100 NVL", (835e12, 60e12, 3.9e12)),
         ("H200", (989e12, 67e12, 4.8e12)),
         ("H100", (989e12, 67e12, 3.35e12))]


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name):
    for key, vals in PEAKS:
        if key in name:
            return key, vals
    raise SystemExit("chip_smoke: no peak table entry for %r" % name)


def bound(shape, dtype_bytes, card):
    """Least time (s) for one fused launch, and which side bounds it:
    ops over the peak for the dtype, bytes (x, w, s, b read once, out
    written once) over the memory rate."""
    N, H, W, Ci, Co = shape
    _, (bf16_peak, f32_peak, bw) = card
    ops = 2.0 * N * H * W * 9 * Ci * Co
    nbytes = dtype_bytes * (N * H * W * (Ci + Co) + 9 * Ci * Co) + 8 * Ci
    t_ops = ops / (bf16_peak if dtype_bytes == 2 else f32_peak)
    t_bytes = nbytes / bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def device_ms(torch, fn, iters, warmup=3):
    """Mean device time of fn() in ms. The stream is first held by a
    sleep kernel so that all `iters` launches are queued before the
    timed window opens: host launch overhead stays out of the number.
    Where the window had opened before the last launch was queued (a slow
    host), it is timed again behind a sleep four times as long, up to
    three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold = 20_000_000
    for attempt in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        opened = start.query()
        torch.cuda.synchronize()
        if not opened:
            break
        hold *= 4
    else:
        print("chip_smoke: the host queued slower than a %d-cycle sleep"
              % (hold // 4), file=sys.stderr)
    return start.elapsed_time(end) / iters


# No kernel runs faster than its bound; a time that puts it past the bound
# by more than ROOFLINE_SLACK is a failed measurement, and the run fails on
# it rather than print it.
ROOFLINE_SLACK = 1.05


def roofline_share(bound_ms, ms, what):
    """bound_ms / ms, the share of the bound a measured time reaches;
    raises where it exceeds ROOFLINE_SLACK."""
    share = bound_ms / ms
    if not share <= ROOFLINE_SLACK:
        raise AssertionError(
            "%s: %.6g ms measured against a bound of %.6g ms (share %.3f): "
            "the measurement is wrong" % (what, ms, bound_ms, share))
    return share


def make_case(torch, shape, dtype, seed):
    N, H, W, Ci, Co = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = torch.randn(N, H, W, Ci, generator=gen, device=dev).to(dtype)
    s = torch.rand(Ci, generator=gen, device=dev) + 0.5
    b = torch.randn(Ci, generator=gen, device=dev) * 0.1
    w = (torch.randn(3, 3, Ci, Co, generator=gen, device=dev)
         * (2.0 / (9 * Ci)) ** 0.5).to(dtype)
    return x, s, b, w


def bn_bound(shape, kernel, dtype_bytes, card):
    """Least time (s) for one launch of a BatchNorm kernel at (N, H, W, C),
    and which side bounds it: its (R, C) tensors read or written once
    (stats reads x; apply reads x, writes out; bwd_reduce reads x, dy;
    bwd_dx reads x, dy, writes dx) plus its (C,) vectors, over the memory
    rate; BN_OPS f32 operations per element over the f32 peak."""
    _, (_, f32_peak, bw) = card
    C = shape[-1]
    n = int(np.prod(shape))
    big = {"stats": 1, "apply": 2, "bwd_reduce": 2, "bwd_dx": 3}[kernel]
    small = {"stats": 2, "apply": 4, "bwd_reduce": 6, "bwd_dx": 6}[kernel]
    t_bytes = (dtype_bytes * n * big + 4 * C * small) / bw
    t_ops = BN_OPS[kernel] * n / f32_peak
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bn_case(torch, R, C, dtype, seed, special=False):
    """(x, gamma, beta, dy) for a BatchNorm of R rows and C channels.
    ``special`` makes channel 0 all zeros and channel 1 |mean| >> std, so
    that the single-pass variance cancels and clamps to 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, C, generator=gen, device="cuda") * 2.0 + 0.5
    if special:
        x[:, 0] = 0.0
        if C > 1:
            x[:, 1] = 1e4 + 1e-3 * x[:, 1]
    g = torch.rand(C, generator=gen, device="cuda") + 0.5
    b = torch.randn(C, generator=gen, device="cuda") * 0.1
    dy = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
    return x.to(dtype), g, b, dy


def same_bits(torch, a, b):
    """Bit equality of two float tensors; a NaN matches any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a.float())
    if not torch.equal(nan, torch.isnan(b.float())):
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(a.view(view)[~nan], b.view(view)[~nan]))


def max_abs_err(torch, a, b):
    """Largest |a - b| over the entries where the reference is finite."""
    ok = torch.isfinite(b.float())
    if not bool(ok.any().item()):
        return 0.0
    return (a.float() - b.float())[ok].abs().max().item()


def bn_check(torch, x2, g, b, dy, act, backward=True):
    """Each BatchNorm kernel against its plain version on the same inputs
    (the plain statistics and sums feed the later kernels); the two folds
    also against their own second launch, bit for bit. Returns {kernel:
    (ok, max abs err, max |ref|, bitwise share)}."""
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    res = {}
    mean, var = BNF.stats(x2)
    mean2, var2 = BNF.stats(x2)
    rm, rv = BNF.stats_reference(x2)
    out = BNF.apply(x2, g, b, rm, rv, BN_EPS, act)
    rout = BNF.apply_reference(x2, g, b, rm, rv, BN_EPS, act)
    torch.cuda.synchronize()
    again = same_bits(torch, mean, mean2) and same_bits(torch, var, var2)
    for name, pairs in (("stats", ((mean, rm), (var, rv))),
                        ("apply", ((out, rout),))):
        ok = all(same_bits(torch, k, r) for k, r in pairs) \
            and (again or name != "stats")
        err = max(max_abs_err(torch, k, r) for k, r in pairs)
        res[name] = (ok, err, 0.0, 1.0 if ok else 0.0)
    if not backward:
        return res
    db, dg = BNF.bwd_reduce(x2, dy, g, b, rm, rv, BN_EPS, act)
    db2, dg2 = BNF.bwd_reduce(x2, dy, g, b, rm, rv, BN_EPS, act)
    rdb, rdg = BNF.bwd_reduce_reference(x2, dy, g, b, rm, rv, BN_EPS, act)
    dx = BNF.bwd_dx(x2, dy, g, b, rm, rv, rdb, rdg, BN_EPS, act)
    rdx = BNF.bwd_dx_reference(x2, dy, g, b, rm, rv, rdb, rdg, BN_EPS, act)
    torch.cuda.synchronize()
    again = same_bits(torch, db, db2) and same_bits(torch, dg, dg2)
    for name, pairs in (("bwd_reduce", ((db, rdb), (dg, rdg))),
                        ("bwd_dx", ((dx, rdx),))):
        ok = again or name != "bwd_reduce"
        err, scale, eq, n = 0.0, 0.0, 0, 0
        for k, r in pairs:
            e = max_abs_err(torch, k, r)
            sc = r.float().abs().max().item()
            ok = ok and bool(torch.isfinite(k.float()).all().item()) \
                and e <= BN_BWD_RTOL * sc
            err, scale = max(err, e), max(scale, sc)
            eq += int((k.view(torch.int16 if k.dtype == torch.bfloat16
                              else torch.int32)
                       == r.view(torch.int16 if r.dtype == torch.bfloat16
                                 else torch.int32)).sum().item())
            n += r.numel()
        res[name] = (ok, err, scale, eq / n)
    return res


def phase_env(torch, state):
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln or "wgmma" in ln]
        ptxas[name] = lines
    emit({"phase": "env", "smi": state["smi"],
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "peaks_from": state["card"][0],
          "nvcc_seconds": seconds, "build_wall_s": wall, "ptxas": ptxas,
          "conv_fwd_ptxas": ptxas_entries(_build.build_log("conv_fused"),
                                          "conv_fused_fwd_bf16_kernel"),
          "image_decoders": image_decoders(), "cv2": cv2_version()})


def cv2_version():
    """OpenCV's version, through the port's one import of it."""
    from mxnet_tpu_torch.base import cv2
    return cv2().__version__


def image_decoders():
    """Which JPEG/PNG decoders this machine offers the port: whether PIL
    and cv2 import (each tried in a child interpreter, so this process
    imports neither) and where libnvjpeg is."""
    import ctypes.util
    import glob
    out = {}
    for mod in ("PIL", "cv2"):
        r = subprocess.run([sys.executable, "-c", "import %s" % mod],
                           capture_output=True, text=True, timeout=120)
        out[mod] = r.returncode == 0
    out["nvjpeg_find_library"] = ctypes.util.find_library("nvjpeg")
    from mxnet_tpu_torch.kernels import _build
    cuda = os.path.dirname(os.path.dirname(os.path.realpath(
        _build._nvcc())))
    out["nvjpeg_in_toolkit"] = sorted(
        glob.glob(os.path.join(cuda, "lib64", "libnvjpeg.so*")) +
        glob.glob(os.path.join(cuda, "targets", "*", "lib",
                               "libnvjpeg.so*")))
    return out


def ptxas_entries(log, name):
    """{entry function: its registers, spill line and any wgmma note} for
    the entries of nvcc's -Xptxas -v report whose name contains `name`."""
    out, cur = {}, None

    def entry(ln):
        key = ln.split("'")[1] if "'" in ln else ln.strip()
        return out.setdefault(key, {"registers": None, "spills": None,
                                    "notes": []})
    for ln in log.splitlines():
        if "wgmma" in ln and name in ln:      # a note names its function
            entry(ln)["notes"].append(ln.strip())
        elif "Compiling entry function" in ln:
            cur = entry(ln) if name in ln else None
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split()[0])
        elif cur is not None and "spill" in ln:
            cur["spills"] = ln.strip()
    return out


def phase_kernel(torch, state):
    phase_kernel_conv_fwd(torch, state)
    phase_kernel_bn(torch, state)
    phase_kernel_conv_bwd(torch, state)
    phase_kernel_apply(torch, state)
    phase_kernel_flash(torch, state)
    phase_kernel_qmm(torch, state)
    phase_kernel_codec(torch, state)
    phase_kernel_adam(torch, state)


def phase_kernel_conv_fwd(torch, state):
    """The forward kernel (row 1) against the plain version at the serving
    shapes and the edge shapes, bf16 and f32 (RTOL); the bf16 forward also
    with the same bits on a second launch at the serving shapes, and
    planned for a card of FEW_SMS SMs. TF32 off for the references."""
    from mxnet_tpu_torch.kernels import conv_fused as CF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(shape, True, True) for shape, _ in RN50_SHAPES] \
        + [(shape, relu, False) for shape, relu in EDGE_SHAPES]
    worst = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for i, (shape, relu, main) in enumerate(cases):
            x, s, b, w = make_case(torch, shape, dtype, seed=100 + i)
            out = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
            again = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu) \
                if main and dtype == torch.bfloat16 else out
            ref = CF.fused_conv_reference(x, s, b, w, relu=relu)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            relaunch = same_bits(torch, out, again)
            ok = bool(torch.isfinite(out).all().item()) \
                and out.shape == ref.shape and out.dtype == ref.dtype \
                and err <= RTOL[dname] * max(scale, 1e-30) and relaunch
            emit({"phase": "kernel", "kernel": "conv_fused", "dtype": dname,
                  "shape": list(shape), "relu": relu, "max_abs_err": err,
                  "ref_max_abs": scale, "tolerance": RTOL[dname] * scale,
                  "same_bits_relaunched": relaunch if again is not out
                  else None, "ok": ok})
            if not ok:
                failures.append((dname, shape, relu, err, scale, relaunch))
            if main:
                w = worst.setdefault(dname, [0.0, 0.0])
                w[0] = max(w[0], err)
                w[1] = max(w[1], err / max(scale, 1e-30))
    state["kernel_err"] = worst
    failures += _fwd_several_items(torch, CF)
    if failures:
        raise AssertionError("conv_fused disagrees with its plain version: "
                             "%s" % failures)


def _fwd_several_items(torch, CF):
    """The bf16 forward kernel with fewer blocks than work items (its plan
    for a card of FEW_SMS SMs), so that each persistent block walks
    several items, at the serving shapes and the ragged edge shapes:
    within RTOL and the same bits relaunched."""
    failures = []
    sm_count = CF._sm_count
    CF._sm_count = lambda dev: FEW_SMS
    try:
        cases = [(shape, True) for shape, _ in RN50_SHAPES] + EDGE_SHAPES[-2:]
        for i, (shape, relu) in enumerate(cases):
            x, s, b, w = make_case(torch, shape, torch.bfloat16, 160 + i)
            p8 = [-(-c // 8) * 8 for c in shape[3:]]
            plan = CF.fwd_plan(*shape[:3], *p8, FEW_SMS)
            out = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
            again = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
            ref = CF.fused_conv_reference(x, s, b, w, relu=relu)
            torch.cuda.synchronize()
            err = max_abs_err(torch, out, ref)
            scale = ref.float().abs().max().item()
            relaunch = same_bits(torch, out, again)
            ok = err <= RTOL["bfloat16"] * max(scale, 1e-30) and relaunch
            emit({"phase": "kernel", "kernel": "conv_fused",
                  "dtype": "bfloat16", "shape": list(shape), "relu": relu,
                  "sm_count": FEW_SMS, "fwd_plan": plan._asdict(),
                  "max_abs_err": err, "ref_max_abs": scale,
                  "same_bits_relaunched": relaunch, "ok": ok})
            if not ok:
                failures.append(("bfloat16", shape, relu, "%d SMs" % FEW_SMS,
                                 err, scale, relaunch))
    finally:
        CF._sm_count = sm_count
    return failures


def phase_kernel_bn(torch, state):
    """The four training-BatchNorm kernels against their plain versions."""
    cases = [(int(np.prod(shape[:3])), shape[-1], True)
             for shape, _ in BN_SHAPES]
    cases += [(r, c, False) for r in BN_EDGE_R for c in BN_EDGE_C]
    worst = {k: [0.0, 0.0] for k in BN_KERNELS}     # abs, relative (bf16)
    summary = {}
    failures = _bn_fresh_thread(torch)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for act in (None, "relu"):
            edge = {k: [True, 0.0, 1.0] for k in BN_KERNELS}
            for i, (R, C, main) in enumerate(cases):
                x2, g, b, dy = bn_case(torch, R, C, dtype, seed=300 + i,
                                       special=not main)
                res = bn_check(torch, x2, g, b, dy, act)
                if main:
                    emit({"phase": "kernel", "kernel": "batchnorm_fused",
                          "dtype": dname, "act": act, "R": R, "C": C,
                          "results": {k: {"ok": v[0], "max_abs_err": v[1],
                                          "ref_max_abs": v[2],
                                          "bitwise_share": v[3]}
                                      for k, v in res.items()}})
                for k, (ok, err, ref, eq) in res.items():
                    if not ok:
                        failures.append((dname, act, R, C, k, err))
                    if main and dtype == torch.bfloat16:
                        worst[k][0] = max(worst[k][0], err)
                        worst[k][1] = max(worst[k][1],
                                          err / max(ref, 1e-30))
                    if not main:
                        edge[k][0] = edge[k][0] and ok
                        edge[k][1] = max(edge[k][1], err)
                        edge[k][2] = min(edge[k][2], eq)
                del x2, g, b, dy
            # an inf entry: NaN statistics, forward bit for bit
            x2, g, b, dy = bn_case(torch, 65, 129, dtype, seed=399)
            x2[32, 64] = float("inf")
            res = bn_check(torch, x2, g, b, dy, act, backward=False)
            for k, (ok, err, _, _) in res.items():
                edge[k][0] = edge[k][0] and ok
                if not ok:
                    failures.append((dname, act, 65, 129, k + "+inf", err))
            summary["%s,act=%s" % (dname, act)] = {
                k: {"ok": v[0], "max_abs_err": v[1], "min_bitwise_share":
                    v[2]} for k, v in edge.items()}
    emit({"phase": "kernel", "kernel": "batchnorm_fused",
          "edge_shapes": {"R": BN_EDGE_R, "C": BN_EDGE_C,
                          "plus": "zero channel, clamped variance, inf"},
          "results": summary,
          "tolerance": {"forward": "bitwise", "backward_rtol": BN_BWD_RTOL}})
    state["bn_err"] = worst
    failures += _bn_several_items(torch)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("batchnorm_fused disagrees with its plain "
                             "version: %s" % failures[:20])


def _bn_several_items(torch):
    """The two folds at BN_SEVERAL_ITEMS, where each persistent block walks
    several items (planned for the card's SMs or for FEW_SMS): stats bit
    for bit, bwd_reduce within BN_BWD_RTOL, both the same bits relaunched
    (bn_check)."""
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    failures = []
    sm_count = BNF._sm_count
    try:
        for i, (R, C, dname, act, n_sm) in enumerate(BN_SEVERAL_ITEMS):
            BNF._sm_count = sm_count if n_sm is None else (lambda dev: n_sm)
            x2, g, b, dy = bn_case(torch, R, C, getattr(torch, dname),
                                   seed=700 + i)
            res = bn_check(torch, x2, g, b, dy, act)
            plans = {k: BNF._plan(k, x2)._asdict()
                     for k in ("stats", "bwd_reduce")}
            emit({"phase": "kernel", "kernel": "batchnorm_fused",
                  "several_items": True, "dtype": dname, "act": act,
                  "R": R, "C": C, "sm_count": n_sm or sm_count(x2.device),
                  "fold_plan": plans,
                  "results": {k: {"ok": res[k][0], "max_abs_err": res[k][1],
                                  "bitwise_share": res[k][3]}
                              for k in ("stats", "bwd_reduce")}})
            failures += [(dname, act, R, C, n_sm, k, res[k][1])
                         for k in ("stats", "bwd_reduce") if not res[k][0]]
            del x2, g, b, dy
    finally:
        BNF._sm_count = sm_count
    return failures


def _in_fresh_thread(torch, fn):
    """fn() as the first call of a new thread: (its result, repr of what it
    raised or None). The launchers that encode tensor maps need the
    device's context current in the calling thread, which a thread's first
    CUDA runtime call makes; a launcher must make that call before its
    first encode."""
    import threading
    got = {}

    def run():
        try:
            got["out"] = fn()
        except Exception as e:     # reported by the caller, with the case
            got["error"] = repr(e)
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=300)
    torch.cuda.synchronize()
    if th.is_alive():
        return None, "the thread did not finish"
    return got.get("out"), got.get("error")


def _bn_fresh_thread(torch):
    """fused_batch_norm forward in a new thread and backward in autograd's
    device thread, before any other backward of the run: there the
    backward reduce is the thread's first CUDA call (the folds' tensor maps
    need the context current in the calling thread). bf16 and f32, against
    the plain versions (bn_check's tolerances)."""
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    failures = []
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        x2, g, b, dy = bn_case(torch, 126, 64, dtype, seed=790 + i)

        def run():
            xr = x2.clone().requires_grad_()
            out, mean, var = BNF.fused_batch_norm(xr, g, b)
            out.backward(dy)
            return out, mean, var, xr.grad
        got, error = _in_fresh_thread(torch, run)
        ok = error is None
        if ok:
            rout, rm, rv = BNF.batchnorm_reference(x2, g, b)
            rdx = BNF.batchnorm_backward_reference(x2, g, b, rm, rv, dy)[0]
            ok = same_bits(torch, got[0], rout) \
                and same_bits(torch, got[1], rm) \
                and same_bits(torch, got[2], rv) \
                and max_abs_err(torch, got[3], rdx) <= BN_BWD_RTOL * \
                rdx.float().abs().max().item()
        emit({"phase": "kernel", "kernel": "batchnorm_fused",
              "fresh_thread": True, "dtype": str(dtype), "R": 126, "C": 64,
              "error": error, "ok": ok})
        if not ok:
            failures.append(("fresh thread", str(dtype), error))
    return failures


def _flash_fresh_thread(torch):
    """The bf16 flash forward, dQ and dK/dV launchers, each called as the
    first CUDA call of a new thread on tensors made beforehand (outputs,
    the plain forward's o and lse, and delta included; a launch through
    the wrapper would allocate first), against the plain versions
    (FLASH_RTOL). The launchers encode tensor maps."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    case = (1, 2, 256, 256, 128, True)
    B, H, Sq, Sk, D, causal = case
    scale = D ** -0.5
    q, k, v, do = flash_case(torch, case, torch.bfloat16, seed=795)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    refs = {"o": ro, "lse": rlse,
            "dq": FA.backward_dq_reference(q, k, v, ro, rlse, do, causal,
                                           scale)}
    refs["dk"], refs["dv"] = FA.backward_dkv_reference(q, k, v, ro, rlse, do,
                                                       causal, scale)
    delta = (do.float() * ro.float()).sum(dim=-1).reshape(B * H, Sq)
    lse = rlse.contiguous()
    out = {n: torch.empty_like(refs[n]) for n in refs}
    fns = {n: FA._fn(n) for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    stream = torch.cuda.current_stream().cuda_stream
    dims = (B * H, H, Sq, Sk, D, int(causal), scale)
    calls = {
        "fwd": (("o", "lse"), lambda: FA._call(
            "forward", case, fns["flash_fwd"], 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out["o"].data_ptr(), out["lse"].data_ptr(), *dims,
            FA._strides(q, k, v, out["o"]), stream)),
        "dq": (("dq",), lambda: FA._call(
            "dq", case, fns["flash_dq"], 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            out["dq"].data_ptr(), *dims,
            FA._strides(q, k, v, do, out["dq"]), stream)),
        "dkv": (("dk", "dv"), lambda: FA._call(
            "dk/dv", case, fns["flash_dkv"], 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            out["dk"].data_ptr(), out["dv"].data_ptr(), *dims,
            FA._strides(q, k, v, do, out["dk"], out["dv"]), stream))}
    torch.cuda.synchronize()
    failures = []
    for kern, (names, fn) in calls.items():
        _, error = _in_fresh_thread(torch, fn)
        errs = {n: max_abs_err(torch, out[n], refs[n]) for n in names}
        ok = error is None and all(
            bool(torch.isfinite(out[n].float()).all().item())
            and errs[n] <= FLASH_RTOL["bfloat16"][n]
            * refs[n].float().abs().max().item() for n in names)
        emit({"phase": "kernel", "kernel": "flash_attention." + kern,
              "fresh_thread": True, "dtype": "bfloat16",
              "shape_bhsd": list(case[:5]), "causal": causal,
              "max_abs_err": errs, "error": error, "ok": ok})
        if not ok:
            failures.append(("fresh thread", kern, error))
    return failures


def _qmm_fresh_thread(torch):
    """An int8 product on the wgmma route (both forms, no split K), its
    launcher called as the first CUDA call of a new thread on tensors made
    beforehand, against the plain version bit for bit. The launcher
    encodes tensor maps."""
    from mxnet_tpu_torch.kernels import quantized_matmul as QM
    M, K, N = 256, 512, 256
    x, w, s = qmm_case(torch, M, K, N, seed=796)
    lda, ldb = x.stride(0), w.stride(1)
    plan = QM.qmm_plan(M, K, N, QM._sm_count(x.device))
    stream = torch.cuda.current_stream().cuda_stream
    failures = []
    for name, sc in (("mm", None), ("mm_scaled", s)):
        ref = QM.quantized_matmul_reference(x, w, sc)
        if QM.route(M, K, N, lda, ldb, x.data_ptr(),
                    w.data_ptr()) != "wgmma" or plan.nsplit != 1:
            raise AssertionError("the fresh-thread int8 case left the "
                                 "wgmma route without split K")
        out = torch.empty_like(ref)
        fn = QM._fn("qmm_s32" if sc is None else "qmm_scaled")
        ptrs = [x.data_ptr(), w.data_ptr()] \
            + ([] if sc is None else [sc.data_ptr()]) + [out.data_ptr()]
        torch.cuda.synchronize()
        err, error = _in_fresh_thread(torch, lambda: fn(
            *ptrs, M, N, K, lda, ldb, 0, 0, plan.bn, plan.nsplit, plan.kps,
            plan.grid, stream))
        ok = error is None and err == 0 and same_bits(torch, out, ref)
        emit({"phase": "kernel", "kernel": "quantized_matmul." + name,
              "fresh_thread": True, "shape_mkn": [M, K, N],
              "launch_error": err, "error": error, "bitwise": ok, "ok": ok})
        if not ok:
            failures.append(("fresh thread", name, err, error))
    return failures


def conv_bwd_case(torch, shape, dtype, seed):
    """(x, s, b, w, dy) for the conv_fused backward at ``shape``."""
    x, s, b, w = make_case(torch, shape, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(shape[:3] + (shape[4],), generator=gen,
                     device="cuda").to(dtype)
    return x, s, b, w, dy


def phase_kernel_conv_bwd(torch, state):
    """The d-input and d-weight kernels (rows 2 and 3) against the plain
    backward, each output within BWD_RTOL of its max |reference|, every
    output with the same bits on a second launch, and both bf16 kernels
    planned for a card of FEW_SMS SMs. TF32 off for the references (also
    when run alone as --phases kernel_conv_bwd)."""
    from mxnet_tpu_torch.kernels import conv_fused as CF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(shape, relu, True) for shape, _ in RN50_TRAIN_SHAPES
             for relu in (True, False)]
    cases += [(shape, relu, False) for shape, _ in EDGE_SHAPES
              for relu in (True, False)]
    worst = {k: [0.0, 0.0] for k in CONV_BWD}      # abs, relative (bf16)
    edge = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for i, (shape, relu, main) in enumerate(cases):
            x, s, b, w, dy = conv_bwd_case(torch, shape, dtype, 700 + i)
            got = dict(zip(BWD_OUTS,
                           CF.fused_conv_backward(x, s, b, w, dy, relu)))
            again = dict(zip(BWD_OUTS,
                             CF.fused_conv_backward(x, s, b, w, dy, relu)))
            ref = dict(zip(BWD_OUTS,
                           CF.fused_conv_backward_reference(x, s, b, w, dy,
                                                            relu)))
            torch.cuda.synchronize()
            res = {}
            for name, r in ref.items():
                g = got[name]
                err = max_abs_err(torch, g, r)
                scale = r.float().abs().max().item()
                relaunch = same_bits(torch, g, again[name])
                ok = g.shape == r.shape and g.dtype == r.dtype \
                    and bool(torch.isfinite(g.float()).all().item()) \
                    and err <= BWD_RTOL[dname][name] * max(scale, 1e-30)
                res[name] = {"ok": ok, "max_abs_err": err,
                             "ref_max_abs": scale,
                             "tolerance": BWD_RTOL[dname][name] * scale,
                             "same_bits_relaunched": relaunch}
                if not ok:
                    failures.append((dname, shape, relu, name, err, scale))
                if not relaunch:
                    failures.append((dname, shape, relu, name + " relaunched",
                                     None, None))
            for k, (outs, _, _) in CONV_BWD.items():
                for name in outs:
                    rel = res[name]["max_abs_err"] / max(
                        res[name]["ref_max_abs"], 1e-30)
                    if main and dtype == torch.bfloat16:
                        worst[k][0] = max(worst[k][0],
                                          res[name]["max_abs_err"])
                        worst[k][1] = max(worst[k][1], rel)
                    if not main:
                        e = edge.setdefault("%s,%s" % (dname, name),
                                            [True, 0.0])
                        e[0] = e[0] and res[name]["ok"] \
                            and res[name]["same_bits_relaunched"]
                        e[1] = max(e[1], rel)
            if main:
                emit({"phase": "kernel", "kernel": "conv_fused_backward",
                      "dtype": dname, "shape": list(shape), "relu": relu,
                      "results": res})
            del x, s, b, w, dy, got, again, ref
    failures += _several_items(torch, CF)
    emit({"phase": "kernel", "kernel": "conv_fused_backward",
          "edge_shapes": [list(sh) for sh, _ in EDGE_SHAPES],
          "relu": [True, False],
          "results": {k: {"ok": v[0], "max_rel_err": v[1]}
                      for k, v in edge.items()},
          "tolerance_rel": BWD_RTOL})
    state["conv_bwd_err"] = worst
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("conv_fused backward disagrees with its plain "
                             "version: %s" % failures[:20])


def _several_items(torch, CF):
    """The bf16 d-input and d-weight kernels with fewer blocks than work
    items (their plans for a card of FEW_SMS SMs), so that each persistent
    block walks several items: every output within BWD_RTOL and the same
    bits relaunched."""
    failures = []
    sm_count = CF._sm_count
    CF._sm_count = lambda dev: FEW_SMS
    try:
        for i, (shape, relu) in enumerate(FEW_SMS_CASES):
            x, s, b, w, dy = conv_bwd_case(torch, shape, torch.bfloat16,
                                           780 + i)
            p8 = [-(-c // 8) * 8 for c in shape[3:]]
            plans = {"dx_plan": CF.dx_plan(*shape[:3], *p8, FEW_SMS),
                     "dw_plan": CF.dw_plan(*shape[:3], *p8, torch.bfloat16,
                                           FEW_SMS)}
            got = CF.fused_conv_backward(x, s, b, w, dy, relu)
            again = CF.fused_conv_backward(x, s, b, w, dy, relu)
            ref = CF.fused_conv_backward_reference(x, s, b, w, dy, relu)
            torch.cuda.synchronize()
            res = {}
            for name, g, a, r in zip(BWD_OUTS, got, again, ref):
                err = max_abs_err(torch, g, r)
                scale = r.float().abs().max().item()
                relaunch = same_bits(torch, g, a)
                ok = err <= BWD_RTOL["bfloat16"][name] * max(scale, 1e-30) \
                    and relaunch
                res[name] = {"ok": ok, "max_abs_err": err,
                             "ref_max_abs": scale,
                             "same_bits_relaunched": relaunch}
                if not ok:
                    failures.append(("bfloat16", shape, relu, "%s, %d SMs"
                                     % (name, FEW_SMS), err, scale))
            emit({"phase": "kernel", "kernel": "conv_fused_backward",
                  "dtype": "bfloat16", "shape": list(shape), "relu": relu,
                  "sm_count": FEW_SMS,
                  "plans": {k: v._asdict() for k, v in plans.items()},
                  "results": res})
    finally:
        CF._sm_count = sm_count
    return failures


def _train_shapes(mx, state):
    """The shapes of ResNet-50's trainable parameters in the order the
    fused train step packs them, from the probe net of ``_arrays``."""
    _arrays(mx, state)
    return state["train_shapes"]


def apply_case(torch, shapes, dtype, momentum, seed):
    """Weights, gradients, momenta (None without momentum), and a
    different lr and wd per parameter, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ws = [torch.randn(sh, generator=gen, device="cuda").to(dtype)
          for sh in shapes]
    gs = [(torch.randn(sh, generator=gen, device="cuda") * 30).to(dtype)
          for sh in shapes]
    ms = [torch.randn(sh, generator=gen, device="cuda").to(dtype)
          if momentum else None for sh in shapes]
    lrs = [0.01 * (1 + (i % 3)) for i in range(len(shapes))]
    wds = [1e-4 * (i % 2) for i in range(len(shapes))]
    return ws, gs, ms, lrs, wds


def _packed_segments(torch, OA, ws, gs, ms, lrs, wds):
    """Each bucket of the plan as one flat segment: (bucket, w, g, state,
    per-element lr, per-element wd), the operands of the plain version. A
    state is None, one tensor (SGD's momentum) or a tuple (Adam's m, v)
    per parameter; the segment's has the same structure."""
    segs = []
    for bucket in OA.bucketize(ws):
        n = [ws[i].numel() for i in bucket]
        cat = (lambda ts: torch.cat([ts[i].reshape(-1) for i in bucket]))
        vec = (lambda vs: torch.cat([torch.full((k,), float(vs[i]),
                                                device="cuda")
                                     for i, k in zip(bucket, n)]))
        st = ms[bucket[0]]
        if isinstance(st, tuple):
            st = tuple(torch.cat([ms[i][k].reshape(-1) for i in bucket])
                       for k in range(len(st)))
        elif st is not None:
            st = cat(ms)
        segs.append((bucket, cat(ws), cat(gs), st, vec(lrs), vec(wds)))
    return segs


def apply_plain(torch, OA, opt, segs, rescale):
    """The plain packed apply over prepared segments: [(new_w, new_m)]."""
    return [OA.packed_apply_reference(opt, w, g, m, lv, wv, rescale)
            for _, w, g, m, lv, wv in segs]


def phase_kernel_apply(torch, state):
    """The packed SGD kernel (row 8) over ResNet-50's trainable shapes,
    bf16 and f32, momentum 0.9 without clip and momentum 0 with: bit for
    bit against its plain version (step_fn over each packed bucket) and
    against the per-parameter step_fn chain."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    shapes = _train_shapes(mx, state)
    rescale = 1.0 / 128
    failures = []
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for momentum, clip in ((0.9, None), (0.0, 0.05)):
            opt = topt.SGD(momentum=momentum, learning_rate=0.01, wd=1e-4,
                           clip_gradient=clip)
            ws, gs, ms, lrs, wds = apply_case(torch, shapes, dtype, momentum,
                                              seed=800)
            chain = [opt.step_fn(w, g, m, lr, wd, rescale)
                     for w, g, m, lr, wd in zip(ws, gs, ms, lrs, wds)]
            segs = _packed_segments(torch, OA, ws, gs, ms, lrs, wds)
            plain = apply_plain(torch, OA, opt, segs, rescale)
            nw = [w.clone() for w in ws]
            nm = [None if m is None else m.clone() for m in ms]
            before = OA.LAUNCHES
            OA.packed_apply(opt, nw, gs, nm, lrs, wds, rescale)
            torch.cuda.synchronize()
            launches = OA.LAUNCHES - before
            vs_chain = vs_plain = True
            for (bucket, *_), (pw, pm) in zip(segs, plain):
                off = 0
                for i in bucket:
                    n = ws[i].numel()
                    worst = max([worst, max_abs_err(torch, nw[i],
                                                    chain[i][0])]
                                + ([max_abs_err(torch, nm[i], chain[i][1])]
                                   if momentum else []))
                    vs_chain = vs_chain and same_bits(torch, nw[i],
                                                      chain[i][0])
                    vs_plain = vs_plain and same_bits(
                        torch, nw[i].reshape(-1), pw[off:off + n])
                    if momentum:
                        vs_chain = vs_chain and same_bits(torch, nm[i],
                                                          chain[i][1])
                        vs_plain = vs_plain and same_bits(
                            torch, nm[i].reshape(-1), pm[off:off + n])
                    off += n
            ok = vs_chain and vs_plain and launches == len(segs)
            emit({"phase": "kernel", "kernel": "optimizer_apply",
                  "dtype": dname, "momentum": momentum, "clip": clip,
                  "tensors": len(shapes),
                  "elements": sum(w.numel() for w in ws),
                  "buckets": len(segs), "launches": launches,
                  "bitwise_vs_plain": vs_plain,
                  "bitwise_vs_per_param_chain": vs_chain, "ok": ok})
            if not ok:
                failures.append((dname, momentum, clip, vs_plain, vs_chain,
                                 launches, len(segs)))
            del ws, gs, ms, chain, segs, plain, nw, nm
    state["apply_err"] = worst
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("optimizer_apply disagrees with its plain "
                             "version: %s" % failures)


def _kv_sizes(mx, state):
    """Element counts of ResNet-50's trainable parameters that the
    compressed kvstore compresses (the JAX rule: size >= the bound), in
    the fused step's packing order."""
    return [int(np.prod(sh)) for sh in _train_shapes(mx, state)
            if int(np.prod(sh)) >= KV_BOUND]


def codec_case(torch, n, dtype, thr, seed):
    """A gradient and a residual of n values on the card, the first ones
    at the codec's edges: r exactly +-thr (in the dtype), +-0.0 (-0.0 +
    -0.0 keeps its sign), +-inf, NaN."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, generator=gen, device="cuda") * (thr * 1.5)
    r = torch.randn(n, generator=gen, device="cuda") * (thr * 0.5)
    sp = torch.tensor([thr, -thr, 0.0, -0.0, float("inf"), -float("inf"),
                       float("nan")], device="cuda")[:n]
    k = sp.numel()
    g[:k] = sp
    r[:k] = torch.where(torch.isfinite(sp), torch.zeros_like(sp), r[:k])
    if n > 3:
        r[3] = -0.0
    return g.to(dtype), r.to(dtype)


def _codec_counts(C):
    return (C.LAUNCHES_QUANTIZE, C.SEGMENTS_QUANTIZE, C.LAUNCHES_DEQUANTIZE,
            C.SEGMENTS_DEQUANTIZE)


def _codec_group_check(torch, C, sizes, dtype, thr, seed):
    """One grouped quantize and dequantize over segments of ``sizes``, each
    twice, against the per-tensor plain versions, bit for bit (words,
    residuals, decoded values in flat and in the views; the same bits on
    the second launch). A size given as (n, "misaligned") is a view one
    element into its buffers, so that its gradient, residual and new
    residual are not 16-byte aligned (the scalar route); in the decoded
    flat buffer every segment after an n % 4 != 0 is misaligned too.
    Returns (sizes that failed, worst abs error, (launches, segments) of
    one quantize and of one dequantize call)."""
    gs, rs, ns = [], [], []
    for i, size in enumerate(sizes):
        n = size[0] if isinstance(size, tuple) else size
        skew = 1 if isinstance(size, tuple) else 0
        g, r = codec_case(torch, n + skew, dtype, thr, seed=seed + i)
        gs.append(g[skew:])
        rs.append(r[skew:])
        ns.append(n)
    before = _codec_counts(C)
    w1, r1 = C.quantize_2bit_group(gs, rs, thr)
    mid = _codec_counts(C)
    w2, r2 = C.quantize_2bit_group(gs, rs, thr)
    f1, v1 = C.dequantize_2bit_group(w1, ns, thr)
    after = _codec_counts(C)
    f2, _ = C.dequantize_2bit_group(w1, ns, thr)
    torch.cuda.synchronize()
    bad, worst, start = [], 0.0, 0
    for i, (g, r, n) in enumerate(zip(gs, rs, ns)):
        rw, rr = C.quantize_2bit_reference(g, r, thr)
        rd = C.dequantize_2bit_reference(rw, n, thr)
        ok = torch.equal(w1[i], rw) and torch.equal(w2[i], rw) \
            and same_bits(torch, r1[i], rr) and same_bits(torch, r2[i], rr) \
            and same_bits(torch, v1[i], rd) \
            and same_bits(torch, f1[start:start + n], rd) \
            and same_bits(torch, f2[start:start + n], rd)
        worst = max(worst, max_abs_err(torch, r1[i], rr),
                    max_abs_err(torch, v1[i], rd))
        start += n
        if not ok:
            bad.append(sizes[i])
    counts = ((mid[0] - before[0], mid[1] - before[1]),
              (after[2] - mid[2], after[3] - mid[3]))
    return bad, worst, counts


def phase_kernel_codec(torch, state):
    """Rows 14-15, the 2-bit quantize and dequantize kernels, against their
    plain versions on the card, bf16 and f32, both thresholds: the single
    calls at every compressed ResNet-50 parameter size and CODEC_EDGE_N;
    one grouped call of all 54 ResNet-50 sizes, CODEC_EDGE_N and a
    misaligned segment (63 segments: one launch each); and, planned for
    FEW_SMS SMs so that every warp walks many chunks, a grouped call of 71
    segments (two launches each) with the edge sizes first. Words,
    residuals and decoded values bit for bit, and the same bits on a
    second launch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import compression as C
    rn50 = _kv_sizes(mx, state)
    sizes = sorted(set(rn50) | set(CODEC_EDGE_N))
    skew = (CODEC_EDGE_N[-1], "misaligned")
    groups = {"path": (rn50 + list(CODEC_EDGE_N) + [skew], None, (1, 63)),
              "few_sms": (list(CODEC_EDGE_N) + [skew] + rn50
                          + list(CODEC_EDGE_N), FEW_SMS, (2, 71))}
    failures = []
    worst = 0.0
    sm_count = C._sm_count
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for thr in CODEC_THRESHOLDS:
            bad = []
            for i, n in enumerate(sizes):
                g, r = codec_case(torch, n, dtype, thr, seed=1400 + i)
                w1, r1 = C.quantize_2bit(g, r, thr)
                w2, r2 = C.quantize_2bit(g, r, thr)
                d1 = C.dequantize_2bit(w1, n, thr)
                d2 = C.dequantize_2bit(w1, n, thr)
                rw, rr = C.quantize_2bit_reference(g, r, thr)
                rd = C.dequantize_2bit_reference(rw, n, thr)
                torch.cuda.synchronize()
                ok = torch.equal(w1, rw) and torch.equal(w2, rw) \
                    and same_bits(torch, r1, rr) and same_bits(torch, r2, rr) \
                    and same_bits(torch, d1, rd) and same_bits(torch, d2, rd)
                worst = max(worst, max_abs_err(torch, r1, rr),
                            max_abs_err(torch, d1, rd))
                if not ok:
                    bad.append(n)
            grouped = {}
            for name, (group, n_sm, want) in groups.items():
                try:
                    if n_sm is not None:
                        C._sm_count = lambda dev, n_sm=n_sm: n_sm
                    gbad, gerr, counts = _codec_group_check(
                        torch, C, group, dtype, thr, seed=1600)
                finally:
                    C._sm_count = sm_count
                worst = max(worst, gerr)
                ok = not gbad and counts == (want, want)
                grouped[name] = {"segments": len(group), "sms": n_sm,
                                 "launches_segments_quantize": counts[0],
                                 "launches_segments_dequantize": counts[1],
                                 "wanted_each": want, "failed_sizes": gbad,
                                 "ok": ok}
                if not ok:
                    failures.append((dname, thr, name, gbad[:5], counts))
            emit({"phase": "kernel", "kernel": "compression",
                  "dtype": dname, "threshold": thr, "sizes": sizes,
                  "bitwise_words_residuals_values": not bad,
                  "same_bits_relaunched": not bad, "failed_sizes": bad,
                  "grouped": grouped,
                  "ok": not bad and all(v["ok"] for v in grouped.values())})
            failures += [(dname, thr, n) for n in bad]
            torch.cuda.empty_cache()
    state["codec_err"] = worst
    if failures:
        raise AssertionError("the 2-bit codec kernels disagree with their "
                             "plain versions: %s" % failures[:20])


def adam_case(torch, shapes, dtype, seed):
    """Weights, gradients and Adam states (m, v >= 0) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ws = [torch.randn(sh, generator=gen, device="cuda").to(dtype)
          for sh in shapes]
    gs = [(torch.randn(sh, generator=gen, device="cuda") * 30).to(dtype)
          for sh in shapes]
    sts = [((torch.randn(sh, generator=gen, device="cuda") * 0.1).to(dtype),
            (torch.rand(sh, generator=gen, device="cuda") * 0.01).to(dtype))
           for sh in shapes]
    return ws, gs, sts


def phase_kernel_adam(torch, state):
    """Row 8's Adam body: the packed Adam kernel over ResNet-50's trainable
    shapes in the fused step's buckets, bf16 and f32, weight decay with
    and without clip, at update counts 1 and 10 (step_lr's bias-corrected
    rate per parameter): bit for bit against its plain version (step_fn
    over each packed bucket) and the per-parameter step_fn chain."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    shapes = _train_shapes(mx, state)
    rescale = 1.0 / 128
    failures = []
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for clip in (None, 0.05):
            for steps in (1, 10):
                opt = topt.Adam(clip_gradient=clip, **ADAM)
                ws, gs, sts = adam_case(torch, shapes, dtype, seed=820)
                for i in range(len(ws)):
                    opt._index_update_count[i] = steps
                lrs = [opt.step_lr(i) for i in range(len(ws))]
                wds = [ADAM["wd"] * (i % 2) for i in range(len(ws))]
                chain = [opt.step_fn(w, g, st, lr, wd, rescale)
                         for w, g, st, lr, wd in zip(ws, gs, sts, lrs, wds)]
                segs = _packed_segments(torch, OA, ws, gs, sts, lrs, wds)
                plain = apply_plain(torch, OA, opt, segs, rescale)
                nw = [w.clone() for w in ws]
                ns = [tuple(t.clone() for t in st) for st in sts]
                before = OA.LAUNCHES
                OA.packed_apply(opt, nw, gs, ns, lrs, wds, rescale)
                torch.cuda.synchronize()
                launches = OA.LAUNCHES - before
                vs_chain = vs_plain = True
                for (bucket, *_), (pw, (pm, pv)) in zip(segs, plain):
                    off = 0
                    for i in bucket:
                        n = ws[i].numel()
                        got = (nw[i], ns[i][0], ns[i][1])
                        want = (chain[i][0],) + tuple(chain[i][1])
                        for a, b, flat in zip(got, want, (pw, pm, pv)):
                            worst = max(worst, max_abs_err(torch, a, b))
                            vs_chain = vs_chain and same_bits(torch, a, b)
                            vs_plain = vs_plain and same_bits(
                                torch, a.reshape(-1), flat[off:off + n])
                        off += n
                ok = vs_chain and vs_plain and launches == len(segs)
                emit({"phase": "kernel", "kernel": "optimizer_apply.adam",
                      "dtype": dname, "clip": clip, "update_count": steps,
                      "tensors": len(shapes),
                      "elements": sum(w.numel() for w in ws),
                      "buckets": len(segs), "launches": launches,
                      "bitwise_vs_plain": vs_plain,
                      "bitwise_vs_per_param_chain": vs_chain, "ok": ok})
                if not ok:
                    failures.append((dname, clip, steps, vs_plain,
                                     vs_chain, launches, len(segs)))
                del ws, gs, sts, chain, segs, plain, nw, ns
    state["adam_err"] = worst
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("the packed Adam apply disagrees with its "
                             "plain version: %s" % failures)


def flash_case(torch, case, dtype, seed, layout="bhsd"):
    """(q, k, v, dO) [B, H, S, D] on the card for ``case``; with layout
    "bshd" the same values held in [B, S, H, D] buffers and seen
    transposed."""
    B, H, Sq, Sk, D, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ts = tuple(torch.randn(B, H, n, D, generator=gen, device="cuda")
               .to(dtype) for n in (Sq, Sk, Sk, Sq))
    if layout == "bshd":
        ts = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in ts)
    return ts


def row_rel_err(torch, a, b):
    """(the largest over rows of a row's max |a - b| over its max |b|, rows
    below FLASH_ROW_FLOOR of the tensor's max taken at that floor; the
    error's RMS over the reference's RMS). A row is the last dim."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    d = a - b
    ref = b.abs().amax(dim=1)
    floor = max(FLASH_ROW_FLOOR * ref.max().item(), 1e-30)
    row = (d.abs().amax(dim=1) / ref.clamp(min=floor)).max().item()
    rms = (d.square().mean().sqrt()
           / b.square().mean().sqrt().clamp(min=1e-30)).item()
    return row, rms


def flash_check(torch, case, dtype, seed, layout="bhsd"):
    """Rows 9-11 against their plain versions on the same inputs (the
    backward pair takes the plain forward's o and lse). bf16 outputs are
    held as a whole and row by row (FLASH_ROWWISE); every output must be
    laid out as the input it belongs to (o and dq as q, dk as k, dv as v).
    Returns ({output: {ok, max_abs_err, ref_max_abs[, max_row_rel_err,
    rms_rel_err]}}, the kernels' outputs, the inputs)."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    q, k, v, do = flash_case(torch, case, dtype, seed, layout)
    causal, scale = case[5], case[4] ** -0.5
    o, lse = FA._flash_forward(q, k, v, causal, scale)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    grads = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)
    rgrads = FA.flash_backward_reference(q, k, v, ro, rlse, do, causal,
                                         scale)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = FLASH_RTOL[dname]
    like = {"o": q, "dq": q, "dk": k, "dv": v}
    res = {}
    for name, a, b in [("o", o, ro), ("lse", lse, rlse)] + list(
            zip(("dq", "dk", "dv"), grads, rgrads)):
        err = max_abs_err(torch, a, b)
        scale_ref = b.float().abs().max().item()
        ok = a.shape == b.shape and a.dtype == b.dtype \
            and bool(torch.isfinite(a.float()).all().item()) \
            and err <= tol[name] * max(scale_ref, 1e-30) \
            and (name == "lse" or a.stride() == like[name].stride())
        r = {"ok": ok, "max_abs_err": err, "ref_max_abs": scale_ref}
        if dtype == torch.bfloat16 and name in FLASH_ROWWISE:
            r["max_row_rel_err"], r["rms_rel_err"] = row_rel_err(torch, a, b)
            r["ok"] = ok and r["max_row_rel_err"] <= tol[name]
        res[name] = r
    return res, (o, lse) + tuple(grads), (q, k, v, do, ro, rlse)


def phase_kernel_flash(torch, state):
    """The flash-attention forward, dQ and dK/dV kernels (rows 9-11)
    against their plain versions: at the LM's attention (batch cut to 1)
    in bf16, contiguous and as the transposed [B, S, H, D] views the LM
    passes, and at the edge shapes in bf16 and f32 (FLASH_RTOL; bf16 also
    row by row); at every shape a second launch must give the same
    bits. First the three bf16 launchers, each as the first CUDA call of a
    new thread (_flash_fresh_thread). TF32 off for the f32 references
    (also when run alone as --phases kernel_flash)."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = _flash_fresh_thread(torch)
    worst = {k: [0.0, 0.0] for k in FLASH_OUTS}    # abs, row-relative
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        cases = [(FLASH_MAIN, lay) for lay in FLASH_LAYOUTS] \
            if dtype == torch.bfloat16 else []
        cases += [(case, "bhsd") for case in FLASH_EDGE]
        edge, edge_same = {}, True
        contiguous = None
        for i, (case, layout) in enumerate(cases):
            main = case == FLASH_MAIN
            # both layouts of the LM shape hold the same values
            seed = 1100 if main else 1100 + i
            res, outs, ins = flash_check(torch, case, dtype, seed, layout)
            # a second launch on the same inputs: the same bits
            q, k, v, do, ro, rlse = ins
            causal, scale = case[5], case[4] ** -0.5
            again = FA._flash_forward(q, k, v, causal, scale) \
                + FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)
            torch.cuda.synchronize()
            same = all(same_bits(torch, a, b) for a, b in zip(outs, again))
            if not same:
                failures.append((dname, case, layout, "second launch bits"))
            for name, r in res.items():
                if not r["ok"]:
                    failures.append((dname, case, layout, name,
                                     r["max_abs_err"], r["ref_max_abs"],
                                     r.get("max_row_rel_err")))
                if not main:
                    e = edge.setdefault(name, [True, 0.0, 0.0])
                    e[0] = e[0] and r["ok"]
                    e[1] = max(e[1], r["max_abs_err"]
                               / max(r["ref_max_abs"], 1e-30))
                    e[2] = max(e[2], r.get("max_row_rel_err", 0.0))
            if not main:
                edge_same = edge_same and same
                del res, outs, ins, again
                continue
            for kern, outs_k in FLASH_OUTS.items():
                for n in outs_k:
                    worst[kern][0] = max(worst[kern][0],
                                         res[n]["max_abs_err"])
                    worst[kern][1] = max(worst[kern][1],
                                         res[n].get("max_row_rel_err", 0.0))
            line = {"phase": "kernel", "kernel": "flash_attention",
                    "dtype": dname, "layout": layout,
                    "shape_bhsd": list(case[:5]), "causal": case[5],
                    "batch_cut_from": LM_BATCH,
                    "strides_q_k_o_dq_dk": [list(t.stride()) for t in (
                        q, k, outs[0], outs[2], outs[3])],
                    "results": res, "second_launch_same_bits": same,
                    "tolerance_rel": FLASH_RTOL[dname],
                    "row_floor": FLASH_ROW_FLOOR}
            if contiguous is None:
                contiguous = outs
            else:
                # a reading, not a check: delta = rowsum(dO * O) is torch's
                # reduction, whose order may follow the layout
                line["same_bits_as_contiguous"] = [
                    same_bits(torch, a, b) for a, b in zip(outs, contiguous)]
            emit(line)
            del again, res, outs, ins
        del contiguous
        emit({"phase": "kernel", "kernel": "flash_attention", "dtype": dname,
              "edge_shapes_bhsd_causal": FLASH_EDGE,
              "results": {k: {"ok": v[0], "max_rel_err": v[1],
                              "max_row_rel_err": v[2]}
                          for k, v in edge.items()},
              "second_launch_same_bits": edge_same,
              "tolerance_rel": FLASH_RTOL[dname]})
    state["flash_err"] = worst
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("flash_attention disagrees with its plain "
                             "version: %s" % failures[:20])


def _build_net(mx, arrays, fuse, dtype, ctx):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    import torch
    net = resnet50_v1(layout="NHWC", fuse=fuse)
    net.initialize(ctx=ctx)
    # the first forward finishes the deferred shapes; then real weights
    net(torch.zeros(1, 3, 224, 224, device=ctx.device))
    mx.convert.load_numpy_params(net, arrays)
    net.cast(dtype)
    return net


def _arrays(mx, state):
    """ResNet-50's weights and running statistics from numpy seed 0, keyed
    by structural name (the same keys with fuse True and False). Also
    records the trainable parameters' shapes in the order the fused train
    step packs them (the block's, by structural name)."""
    if "arrays" not in state:
        import torch
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
        probe = resnet50_v1(layout="NHWC", fuse=True)
        probe.initialize(ctx=mx.cpu())
        probe(torch.zeros(1, 3, 224, 224))
        state["arrays"] = mx.convert.random_numpy_params(
            mx.convert.param_shapes(probe), seed=0)
        state["train_shapes"] = [tuple(p.shape)
                                 for p in probe._all_params_list()
                                 if p.grad_req != "null"]
    return state["arrays"]


def phase_serve(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    gpu = mx.gpu(0)
    rs = np.random.RandomState(1)
    requests = [rs.rand(32, 3, 224, 224).astype("float32") for _ in range(4)]

    # -- the main path: bf16, fused --------------------------------------
    net = _build_net(mx, arrays, True, "bfloat16", gpu)
    ref_net = _build_net(mx, arrays, False, "bfloat16", gpu)
    torch.cuda.synchronize()
    CF.LAUNCHES = 0
    answers, logits = [], []
    for req in requests:
        out = net(torch.from_numpy(req).to("cuda", torch.bfloat16))
        logits.append(out)
        answers.append(torch.topk(out.float(), 5).indices.tolist())
    torch.cuda.synchronize()
    launches = CF.LAUNCHES
    state.setdefault("launches", {})["conv_fused"] = launches
    if launches != 16 * len(requests):
        raise AssertionError("conv_fused launched %d times for %d forwards "
                             "(want 16 each)" % (launches, len(requests)))
    worst, scale, top1 = 0.0, 0.0, 0
    for req, out in zip(requests, logits):
        if tuple(out.shape) != (32, 1000) or \
                not bool(torch.isfinite(out).all().item()):
            raise AssertionError("bad logits %s" % (tuple(out.shape),))
        ref = ref_net(torch.from_numpy(req).to("cuda", torch.bfloat16))
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        scale = max(scale, ref.float().abs().max().item())
        top1 += int((out.float().argmax(1) == ref.float().argmax(1))
                    .sum().item())
    ok16 = worst <= LOGIT_RTOL["bfloat16"] * scale
    emit({"phase": "serve", "dtype": "bfloat16", "requests": len(requests),
          "batch": 32, "launches": launches,
          "top5_first_image": answers[0][0],
          "max_abs_diff_vs_unfused": worst, "logit_max_abs": scale,
          "tolerance": LOGIT_RTOL["bfloat16"] * scale,
          "top1_agree": top1 / (32.0 * len(requests)), "ok": ok16})
    del net, ref_net, logits

    # -- once more in f32, TF32 off --------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = _build_net(mx, arrays, True, "float32", gpu)
    ref_net = _build_net(mx, arrays, False, "float32", gpu)
    x = torch.from_numpy(requests[0]).cuda()
    before = CF.LAUNCHES
    out = net(x)
    torch.cuda.synchronize()
    n32 = CF.LAUNCHES - before
    ref = ref_net(x)
    err32 = (out - ref).abs().max().item()
    scale32 = ref.abs().max().item()
    cpu_net = _build_net(mx, arrays, False, "float32", mx.cpu())
    cpu_ref = cpu_net(torch.from_numpy(requests[0][:2]))
    err_cpu = (out[:2].cpu() - cpu_ref).abs().max().item()
    ok32 = n32 == 16 and bool(torch.isfinite(out).all().item()) \
        and err32 <= LOGIT_RTOL["float32"] * scale32 \
        and err_cpu <= LOGIT_RTOL["float32"] * scale32
    emit({"phase": "serve", "dtype": "float32", "batch": 32,
          "launches": n32, "max_abs_diff_vs_unfused": err32,
          "max_abs_diff_vs_cpu_port": err_cpu, "logit_max_abs": scale32,
          "tolerance": LOGIT_RTOL["float32"] * scale32, "ok": ok32})
    if not (ok16 and ok32):
        raise AssertionError("serving logits out of tolerance")


# -- int8 inference: the quantized_matmul kernels, quantize_net, the
#    nd.contrib op family ------------------------------------------------

def qmm_bound(M, K, N, scaled, card):
    """Least time (s) of one int8 product, and which side bounds it: x
    (M*K) and w (K*N) int8 read once and the (M, N) int32 or f32 output
    written once (the f32 scales read too), over the memory rate; 2*M*N*K
    operations over the int8 peak."""
    nbytes = M * K + K * N + 4.0 * M * N + (4.0 * N if scaled else 0.0)
    t_ops = 2.0 * M * N * K / INT8_PEAKS[card[0]]
    t_bytes = nbytes / card[1][2]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _build_nchw(mx, arrays, ctx):
    """resnet50_v1() (NCHW, float32) on ``ctx`` with the numpy weights."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    import torch
    net = resnet50_v1()
    net.initialize(ctx=ctx)
    net(torch.zeros(1, 3, 224, 224, device=ctx.device))
    mx.convert.load_numpy_params(net, arrays)
    return net


def _int8_net(mx, state, ctx, calib=None):
    """int8 ResNet-50 v1 on ``ctx``: quantize_net over the float network,
    naive calibration on ``calib`` (numpy batches), or with calib None
    every threshold 1.0 (a carried state is loaded after)."""
    from mxnet_tpu_torch.contrib import quantization as Q
    net = _build_nchw(mx, _arrays(mx, state), ctx)
    Q.quantize_net(net, calib_data=calib,
                   calib_mode="none" if calib is None else "naive")
    return net


# The int8 kernels' launch counters: the wgmma route's (int32 and scaled
# form), the byte route's (a tree without that route counts 0), and the w
# copies.
QMM_COUNTERS = {"mm": "LAUNCHES_MM", "mm_scaled": "LAUNCHES_MM_SCALED",
                "mm_bytes": "LAUNCHES_MM_BYTES",
                "mm_scaled_bytes": "LAUNCHES_MM_SCALED_BYTES",
                "copies": "COPIES"}


def _qmm_counts(QM):
    return {k: getattr(QM, v, 0) for k, v in QMM_COUNTERS.items()}


def _zero_qmm(QM):
    for v in QMM_COUNTERS.values():
        if hasattr(QM, v):
            setattr(QM, v, 0)


def _qmm_route_of(QM, before, name):
    """The route the launches since ``before`` (_qmm_counts) of form
    ``name`` took: "wgmma", "bytes", "both", or None where the tree counts
    no routes."""
    now = _qmm_counts(QM)
    if not hasattr(QM, "LAUNCHES_MM_BYTES"):
        return None
    fast = now[name] > before[name]
    slow = now[name + "_bytes"] > before[name + "_bytes"]
    return "both" if fast and slow else "wgmma" if fast else \
        "bytes" if slow else None


def _record_products(QM, fn):
    """fn() with every quantized_matmul call on the card recorded as (M, K,
    N, scaled); returns (fn's result, the calls)."""
    calls = []
    orig = QM.quantized_matmul

    def recording(x, w, scales=None):
        if x.is_cuda:
            calls.append((int(x.shape[0]), int(x.shape[1]),
                          int(w.shape[1]), scales is not None))
        return orig(x, w, scales)
    QM.quantized_matmul = recording
    try:
        return fn(), calls
    finally:
        QM.quantized_matmul = orig


def _layer_inputs(net, fn):
    """fn() with the input of every int8 layer of ``net`` recorded in call
    order as (layer, tensor); returns (fn's result, the list)."""
    from mxnet_tpu_torch.contrib import quantization as Q
    layers = list(Q.quantized_layers(net).values())
    seen = []
    for layer in layers:
        def wrapped(x, _layer=layer, _orig=layer.quantize_input):
            seen.append((_layer, x))
            return _orig(x)
        layer.quantize_input = wrapped
    try:
        return fn(), seen
    finally:
        for layer in layers:
            del layer.quantize_input


def _int8_shapes(torch, mx, state):
    """[((M, K, N), count)] of the int8 products of int8 ResNet-50 v1 at
    batch 32, read off one forward of the network on the card."""
    if "int8_shapes" not in state:
        from mxnet_tpu_torch.kernels import quantized_matmul as QM
        net = _int8_net(mx, state, mx.gpu(0))
        x = torch.rand(INT8_BATCH, 3, 224, 224, device="cuda")
        _, calls = _record_products(QM, lambda: net(x))
        torch.cuda.synchronize()
        if len(calls) != INT8_LAYERS or not all(c[3] for c in calls):
            raise AssertionError("int8 ResNet-50 made %d products (%d "
                                 "scaled), want %d scaled"
                                 % (len(calls), sum(c[3] for c in calls),
                                    INT8_LAYERS))
        distinct = {}
        for c in calls:
            distinct[c[:3]] = distinct.get(c[:3], 0) + 1
        state["int8_shapes"] = sorted(distinct.items())
        del net, x
        torch.cuda.empty_cache()
    return state["int8_shapes"]


def qmm_case(torch, M, K, N, seed, lo=-127):
    """x (M, K) int8, w (K, N) int8 laid out K-contiguous (the transpose of
    an (N, K) weight, as the int8 layers hold it), scales (N,) f32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(shape, low):
        return torch.randint(low, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)
    x = ints((M, K), lo)
    w = ints((N, K), -127).t()
    s = torch.rand(N, generator=gen, device="cuda") * 1e-3 + 1e-6
    return x, w, s


def _int_err(a, b):
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def qmm_check(torch, x, w, s):
    """Both forms of the kernel against the plain version, and a second
    launch: {"mm"|"mm_scaled": (equal bit for bit, second launch same
    bits, max abs err, route taken)}."""
    from mxnet_tpu_torch.kernels import quantized_matmul as QM
    res = {}
    for name, sc in (("mm", None), ("mm_scaled", s)):
        before = _qmm_counts(QM)
        out = QM.quantized_matmul(x, w, sc)
        ref = QM.quantized_matmul_reference(x, w, sc)
        again = QM.quantized_matmul(x, w, sc)
        torch.cuda.synchronize()
        res[name] = (same_bits(torch, out, ref), same_bits(torch, out, again),
                     _int_err(out, ref), _qmm_route_of(QM, before, name))
    return res


def _qmm_record(state, phase, kind, shape, res, failures, route=None,
                **extra):
    """Emit one kernel-check line of qmm_check's result, raise the worst
    errors in state["qmm_err"], mark the shape checked, and add it to
    ``failures`` if it failed: if a launch disagreed, or, with ``route``,
    if a launch took another route."""
    ok = all(r[0] and r[1] for r in res.values())
    routes = {k: v[3] for k, v in res.items()}
    if route is not None:
        ok = ok and all(r == route for r in routes.values())
    emit(dict({"phase": phase, "kernel": "quantized_matmul",
               "case": kind, "shape_mkn": list(shape),
               "bitwise": {k: v[0] for k, v in res.items()},
               "second_launch_same_bits": {k: v[1] for k, v in res.items()},
               "max_abs_err": {k: v[2] for k, v in res.items()},
               "route": routes, "route_wanted": route, "ok": ok}, **extra))
    worst = state.setdefault("qmm_err", {"mm": 0.0, "mm_scaled": 0.0})
    for k, v in res.items():
        worst[k] = max(worst[k], v[2])
    state.setdefault("qmm_checked", set()).add(tuple(shape))
    if not ok:
        failures.append((kind, shape))


def phase_kernel_qmm(torch, state):
    """Rows 12 and 13 (quantized_matmul: the int32 and the scaled form)
    against the plain version on the card, bit for bit, each launched
    twice for the same bits: at every distinct (M, K, N) of int8 ResNet-50
    v1 at batch 32 (read off the network; each must take the wgmma route),
    at QMM_EDGE (the route the wrapper's predicate names), at
    QMM_WGMMA_EDGE, and planned for FEW_SMS SMs at QMM_FEW_SMS (wgmma);
    with w given N-contiguous (the wrapper copies it once), x as a
    row-strided view (taken in place, wgmma), a view of x 1 byte off
    16-byte alignment (the byte route) and transposed (refused); and at
    int8 extremes. First the wgmma launcher as the first CUDA call of a
    new thread (_qmm_fresh_thread)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import quantized_matmul as QM

    routed = hasattr(QM, "route")
    wgmma = "wgmma" if routed else None
    shapes = _int8_shapes(torch, mx, state)
    failures = _qmm_fresh_thread(torch)

    def record(kind, shape, res, route=None, **extra):
        _qmm_record(state, "kernel", kind, shape, res, failures, route,
                    **extra)

    def predicted(x, w):
        M, K = x.shape
        N = w.shape[1]
        return QM.route(M, K, N, x.stride(0) if M > 1 else K,
                        w.stride(1) if N > 1 else K, x.data_ptr(),
                        w.data_ptr()) if routed else None

    def plan(M, K, N, n_sm):
        if not routed:
            return {}
        p = QM.qmm_plan(M, K, N, n_sm)
        return {"plan": {"bn": p.bn, "nsplit": p.nsplit, "kps": p.kps,
                         "items": p.items, "grid": p.grid, "n_sm": n_sm}}

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for i, ((M, K, N), _) in enumerate(shapes):
        x, w, s = qmm_case(torch, M, K, N, 300 + i, -127)
        record("resnet50_b32", (M, K, N), qmm_check(torch, x, w, s), wgmma,
               **plan(M, K, N, n_sm))
    for i, (M, K, N) in enumerate(QMM_EDGE):
        x, w, s = qmm_case(torch, M, K, N, 400 + i, -128)
        record("edge", (M, K, N), qmm_check(torch, x, w, s), predicted(x, w))
    for i, (M, K, N) in enumerate(QMM_WGMMA_EDGE):
        x, w, s = qmm_case(torch, M, K, N, 450 + i, -128)
        record("wgmma_edge", (M, K, N), qmm_check(torch, x, w, s), wgmma,
               **plan(M, K, N, n_sm))
    if routed:
        counted = QM._sm_count
        QM._sm_count = lambda dev: FEW_SMS
        try:
            for i, (M, K, N) in enumerate(QMM_FEW_SMS):
                x, w, s = qmm_case(torch, M, K, N, 470 + i, -128)
                record("few_sms", (M, K, N), qmm_check(torch, x, w, s),
                       wgmma, **plan(M, K, N, FEW_SMS))
        finally:
            QM._sm_count = counted
    x, w, s = qmm_case(torch, 300, 96, 200, 500, -128)
    copies = QM.COPIES
    record("w_n_contiguous", (300, 96, 200),
           qmm_check(torch, x, w.contiguous(), s), wgmma,
           copies=QM.COPIES - copies)
    if QM.COPIES - copies != 4:          # 2 launches of each form
        failures.append(("w_n_contiguous copies", QM.COPIES - copies))
    wide = torch.zeros(300, 112, dtype=torch.int8, device="cuda")
    wide[:, :96] = x
    record("x_row_strided_view", (300, 96, 200),
           qmm_check(torch, wide[:, :96], w, s), wgmma, x_strides=[112, 1])
    wide[:, 1:97] = x
    record("x_misaligned_view", (300, 96, 200),
           qmm_check(torch, wide[:, 1:97], w, s),
           "bytes" if routed else None, x_offset_bytes=1)
    try:
        QM.quantized_matmul(x.t().contiguous().t(), w)
        failures.append(("x with K strided", "not refused"))
    except ValueError as e:
        emit({"phase": "kernel", "kernel": "quantized_matmul",
              "case": "x_k_strided", "refused": str(e)[:100]})
    for i, (fx, fw) in enumerate(((-128, -128), (127, -128), (127, 127),
                                  (-128, 127))):
        xe = torch.full((200, 4608), fx, dtype=torch.int8, device="cuda")
        we = torch.full((72, 4608), fw, dtype=torch.int8, device="cuda").t()
        record("extreme_%d_%d" % (fx, fw), (200, 4608, 72),
               qmm_check(torch, xe, we, s[:72]), wgmma, acc=4608 * fx * fw)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("quantized_matmul disagrees with its plain "
                             "version or took another route: %s" % failures)


def _qmm_path_shapes(torch, state, calls):
    """Rows 12 and 13 against the plain version, bit for bit and with a
    second launch, at every distinct (M, K, N) of ``calls`` (the products
    the main path gave the kernel) that no earlier check covered: batch
    256's products are 8x taller than batch 32's (M up to 3,211,264 at the
    stem), which exercises the large-grid indexing. Each must take the
    wgmma route. The float64 plain version of the largest needs about 6
    GB."""
    from mxnet_tpu_torch.kernels import quantized_matmul as QM
    distinct = sorted({c[:3] for c in calls})
    todo = [s for s in distinct if s not in state.get("qmm_checked", ())]
    failures = []
    for i, (M, K, N) in enumerate(todo):
        x, w, s = qmm_case(torch, M, K, N, 600 + i)
        _qmm_record(state, "serve_int8", "main_path", (M, K, N),
                    qmm_check(torch, x, w, s), failures,
                    "wgmma" if hasattr(QM, "route") else None)
        del x, w, s
        torch.cuda.empty_cache()
    emit({"phase": "serve_int8", "check": "quantized_matmul at every product "
          "shape of the main path, against the plain version",
          "distinct_shapes": len(distinct), "checked_here": len(todo),
          "largest_mkn": list(max(distinct)) if distinct else None,
          "failed": failures, "ok": not failures})
    if failures:
        raise AssertionError("quantized_matmul disagrees with its plain "
                             "version on the main path: %s" % failures)


def _division_check(torch):
    """The quantize passes divide by a tensor on the card: PyTorch's CUDA
    division by a Python (or CPU) scalar multiplies by its reciprocal, which
    can differ from the CPU's true division in the last bit and so move a
    value across an int8 rounding boundary. 4M values / 4 scales: the card
    against the CPU, by a Python scalar and by a device tensor."""
    from mxnet_tpu_torch.ops.quantized import quantize_codes
    x = torch.randn(4_000_000, generator=torch.Generator().manual_seed(0)) * 3
    res = {"by_python_scalar": [0, 0], "by_device_tensor": [0, 0]}
    for sv in (0.0123456789, 1 / 127.0, 0.3, 2.0 / 127.0):
        host = x / torch.tensor(sv)
        codes = quantize_codes(x, sv)
        for key, card in (("by_python_scalar", x.cuda() / sv),
                          ("by_device_tensor", x.cuda() / torch.full(
                              (), sv, device="cuda"))):
            res[key][0] += int((card.cpu() != host).sum().item())
            res[key][1] += int((torch.clamp(torch.round(card), -127, 127)
                                .to(torch.int8).cpu() != codes).sum().item())
        card_codes = quantize_codes(x.cuda(), sv).cpu()
        res.setdefault("quantize_codes_flips", 0)
        res["quantize_codes_flips"] += int((card_codes != codes).sum().item())
    ok = res["by_device_tensor"] == [0, 0] and res["quantize_codes_flips"] == 0
    emit({"phase": "serve_int8", "check": "division by a scale, card vs CPU "
          "(4 scales x 4M values): [quotients differing, int8 codes "
          "differing]", **res, "ok": ok})
    if not ok:
        raise AssertionError("division by a device tensor differs from the "
                             "CPU's: %s" % res)


def phase_serve_int8(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as Q
    from mxnet_tpu_torch.kernels import quantized_matmul as QM

    _division_check(torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = mx.gpu(0)
    arrays = _arrays(mx, state)
    rs = np.random.RandomState(2)
    calib = [rs.rand(INT8_BATCH, 3, 224, 224).astype("float32")
             for _ in range(INT8_CALIB)]
    rs = np.random.RandomState(0)
    requests = [rs.rand(INT8_BATCH, 3, 224, 224).astype("float32")
                for _ in range(4)] + [rs.rand(256, 3, 224, 224)
                                      .astype("float32")]
    float_net = _build_nchw(mx, arrays, gpu)
    net = _build_nchw(mx, arrays, gpu)
    t0 = time.perf_counter()
    Q.quantize_net(net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    n_layers = len(Q.quantized_layers(net))
    if n_layers != INT8_LAYERS:
        raise AssertionError("quantize_net made %d int8 layers, want %d"
                             % (n_layers, INT8_LAYERS))

    # -- the main path: 4 requests of 32, then one batch of 256 ------------
    def serve():
        out = []
        for i, req in enumerate(requests):
            if i == len(requests) - 1:
                torch.cuda.reset_peak_memory_stats()
            out.append(net(torch.from_numpy(req).cuda()))
        return out

    torch.cuda.synchronize()
    _zero_qmm(QM)
    logits, calls = _record_products(QM, serve)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = _qmm_counts(QM)
    state.setdefault("launches", {})["quantized_matmul.mm_scaled"] = \
        counts["mm_scaled"]
    want = INT8_LAYERS * len(requests)
    for req, out in zip(requests[:4], logits):
        emit({"phase": "serve_int8", "request_top5":
              torch.topk(out, 5).indices.tolist()})
    worst_rel, top1, n_img = 0.0, 0, 0
    for req, out in zip(requests, logits):
        if tuple(out.shape) != (req.shape[0], 1000) or \
                not bool(torch.isfinite(out).all().item()):
            raise AssertionError("bad int8 logits %s" % (tuple(out.shape),))
        ref = float_net(torch.from_numpy(req).cuda())
        err = (out - ref).abs().max().item()
        worst_rel = max(worst_rel, err / ref.abs().max().item())
        top1 += int((out.argmax(1) == ref.argmax(1)).sum().item())
        n_img += req.shape[0]
    # every launch of the path on the wgmma route
    ok_main = counts == {"mm": 0, "mm_scaled": want, "mm_bytes": 0,
                         "mm_scaled_bytes": 0, "copies": 0} \
        and len(calls) == want and worst_rel <= INT8_LOGIT_RTOL
    emit({"phase": "serve_int8", "dtype": "int8 layers, float32 between",
          "requests": [int(r.shape[0]) for r in requests],
          "int8_layers": n_layers, "calibration_s": calib_s,
          "launches": counts, "launches_wanted": {"mm": 0, "mm_scaled": want,
                                                  "mm_bytes": 0,
                                                  "mm_scaled_bytes": 0},
          "products_recorded": len(calls),
          "max_rel_diff_vs_float32": worst_rel,
          "tolerance_rel": INT8_LOGIT_RTOL, "top1_agree_with_float32":
              top1 / float(n_img),
          "peak_memory_b256_bytes": peak, "ok": ok_main})
    del logits
    if not ok_main:
        raise AssertionError("int8 serving: launches %s (want %d scaled on "
                             "the wgmma route, no other) or logits %.4g of "
                             "max from float32" % (counts, want, worst_rel))
    _qmm_path_shapes(torch, state, calls)
    state["int8"] = {"net": net, "float_net": float_net}
    _int8_card_vs_cpu(torch, mx, state, net, requests[0][:2], calib[0][:2])
    _int8_op_family(torch, mx, state, net, requests[0])
    torch.cuda.empty_cache()


def _int8_card_vs_cpu(torch, mx, state, net, x2, calib2):
    """The card against the port on the CPU for two images under one
    carried state: the stem's codes and int32 sums bit for bit, every
    layer's codes counted, the logits within INT8_CARD_CPU_RTOL; then both
    calibrated on the same two images: int8 weights and weight scales bit
    for bit, thresholds within INT8_THRESHOLD_RTOL."""
    from mxnet_tpu_torch.kernels import quantized_matmul as QM
    cpu_net = _int8_net(mx, state, mx.cpu())
    mx.convert.load_quantized_state(cpu_net, mx.convert.quantized_state(net))
    out_card, seen_card = _layer_inputs(
        net, lambda: net(torch.from_numpy(x2).cuda()))
    out_cpu, seen_cpu = _layer_inputs(
        cpu_net, lambda: cpu_net(torch.from_numpy(x2)))
    flips, layers_flipped = 0, 0
    for (lc, xc), (lp, xp) in zip(seen_card, seen_cpu):
        n = int((lc.quantize_input(xc).cpu() != lp.quantize_input(xp))
                .sum().item())
        flips += n
        layers_flipped += int(n > 0)
    (stem_c, x_c), (stem_p, x_p) = seen_card[0], seen_cpu[0]
    codes_c, codes_p = stem_c.quantize_input(x_c), stem_p.quantize_input(x_p)
    acc_c = QM.quantized_matmul(stem_c.columns(codes_c)[0], stem_c._wmat)
    acc_p = QM.quantized_matmul(stem_p.columns(codes_p)[0], stem_p._wmat)
    stem_ok = bool(torch.equal(codes_c.cpu(), codes_p)) \
        and bool(torch.equal(acc_c.cpu(), acc_p))
    err = (out_card.cpu() - out_cpu).abs().max().item()
    scale = out_cpu.abs().max().item()
    ok_fwd = stem_ok and len(seen_card) == len(seen_cpu) == INT8_LAYERS \
        and err <= INT8_CARD_CPU_RTOL * scale

    card = _int8_net(mx, state, mx.gpu(0), calib=[calib2])
    host = _int8_net(mx, state, mx.cpu(), calib=[calib2])
    sc, sp = mx.convert.quantized_state(card), mx.convert.quantized_state(host)
    weights_ok = sorted(sc) == sorted(sp) and all(
        np.array_equal(sc[p]["wq"], sp[p]["wq"])
        and np.array_equal(sc[p]["w_scale"].view(np.int32),
                           sp[p]["w_scale"].view(np.int32)) for p in sc)
    thr_rel = max(abs(sc[p]["act_scale"] - sp[p]["act_scale"])
                  / sp[p]["act_scale"] for p in sc)
    ok_cal = weights_ok and thr_rel <= INT8_THRESHOLD_RTOL
    emit({"phase": "serve_int8", "check": "card vs the port on the CPU, "
          "two images, one carried state",
          "stem_codes_and_int32_sums_bitwise": stem_ok,
          "code_flips": flips, "layers_with_flips": layers_flipped,
          "logits_max_abs_diff": err, "logit_max_abs": scale,
          "tolerance": INT8_CARD_CPU_RTOL * scale,
          "int8_weights_and_scales_bitwise": weights_ok,
          "threshold_max_rel_diff": thr_rel,
          "threshold_tolerance_rel": INT8_THRESHOLD_RTOL,
          "ok": ok_fwd and ok_cal})
    if not (ok_fwd and ok_cal):
        raise AssertionError("int8 card vs CPU out of bounds")


def _int8_op_family(torch, mx, state, net, req):
    """nd.contrib.quantized_conv at each distinct convolution of the int8
    network at batch 32 (1x1 stride 1 straight to the kernel, the others
    through im2col) and quantized_fully_connected at 2048 -> 1000, on the
    card, each against the port on the CPU on the batch's first two
    images: int32 payloads and ranges bit for bit; exactly one int32
    kernel launch per call, on the wgmma route, and no scaled one."""
    from mxnet_tpu_torch.contrib import quantization as Q
    from mxnet_tpu_torch.kernels import quantized_matmul as QM

    _, seen = _layer_inputs(net, lambda: net(torch.from_numpy(req).cuda()))
    convs = []
    for layer, x in seen:
        if isinstance(layer, Q._QuantizedConv2D):
            cfg = (tuple(x.shape[1:]), tuple(layer._wq.shape),
                   tuple(layer._strides), tuple(layer._padding))
            if cfg not in convs:
                convs.append(cfg)
    del seen
    gen = torch.Generator(device="cuda").manual_seed(700)

    def ints(shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    def compare(card, host):
        return all(same_bits(torch, c[:2].cpu() if i == 0 else c.cpu(), h)
                   for i, (c, h) in enumerate(zip(card, host)))

    torch.cuda.synchronize()
    _zero_qmm(QM)

    def run():
        results = []
        for (ci, h, w), wshape, stride, pad in convs:
            data, weight = ints((INT8_BATCH, ci, h, w)), ints(wshape)
            kw = dict(kernel=wshape[2:], stride=stride, pad=pad,
                      num_filter=wshape[0], no_bias=True)
            card = mx.nd.contrib.quantized_conv(
                data, weight, None, -1.0, 1.0, -0.5, 0.5, None, None, **kw)
            host = mx.nd.contrib.quantized_conv(
                data[:2].cpu(), weight.cpu(), None, -1.0, 1.0, -0.5, 0.5,
                None, None, **kw)
            results.append((("conv", ci, h, w) + wshape + stride + pad,
                            compare(card, host)))
        data, weight, bias = ints((INT8_BATCH, 2048)), ints((1000, 2048)), \
            ints((1000,))
        args = (-1.0, 1.0, -0.5, 0.5, -0.1, 0.1)
        card = mx.nd.contrib.quantized_fully_connected(
            data, weight, bias, *args, num_hidden=1000)
        host = mx.nd.contrib.quantized_fully_connected(
            data[:2].cpu(), weight.cpu(), bias.cpu(), *args, num_hidden=1000)
        results.append((("fc", 2048, 1000), compare(card, host)))
        return results

    results, calls = _record_products(QM, run)
    torch.cuda.synchronize()
    counts = _qmm_counts(QM)
    state["launches"]["quantized_matmul.mm"] = counts["mm"]
    state["int8_op_shapes"] = [c[:3] for c in calls]
    bad = [cfg for cfg, ok in results if not ok]
    ok = not bad and counts["mm"] == len(results) \
        and counts["mm_scaled"] == counts["mm_bytes"] == 0 \
        and counts["mm_scaled_bytes"] == 0 and not any(c[3] for c in calls)
    emit({"phase": "serve_int8", "check": "nd.contrib op family at "
          "ResNet-50's shapes, card vs CPU", "calls": len(results),
          "launches": counts, "product_shapes_mkn": [list(c[:3])
                                                     for c in calls],
          "bitwise": not bad, "mismatched": bad, "ok": ok})
    if not ok:
        raise AssertionError("nd.contrib quantized ops: %s, launches %s"
                             % (bad, counts))


def _bn_counts(BNF):
    return {"stats": BNF.LAUNCHES_STATS, "apply": BNF.LAUNCHES_APPLY,
            "bwd_reduce": BNF.LAUNCHES_BWD_REDUCE,
            "bwd_dx": BNF.LAUNCHES_BWD_DX,
            "finalize": BNF.LAUNCHES_FINALIZE, "copies": BNF.COPIES}


def _conv_counts(CF):
    return {"fwd": CF.LAUNCHES, "bwd_dx": CF.LAUNCHES_BWD_DX,
            "bwd_dw": CF.LAUNCHES_BWD_DW, "finalize": CF.LAUNCHES_FINALIZE,
            "reduce": CF.LAUNCHES_REDUCE, "copies": CF.COPIES}


def _zero_counts(BNF, CF, OA=None):
    BNF.LAUNCHES_STATS = BNF.LAUNCHES_APPLY = 0
    BNF.LAUNCHES_BWD_REDUCE = BNF.LAUNCHES_BWD_DX = 0
    BNF.LAUNCHES_FINALIZE = BNF.COPIES = 0
    CF.LAUNCHES = CF.LAUNCHES_BWD_DX = CF.LAUNCHES_BWD_DW = 0
    CF.LAUNCHES_FINALIZE = CF.LAUNCHES_REDUCE = CF.COPIES = 0
    if OA is not None:
        OA.LAUNCHES = 0


def _batch(state):
    """The training batch: 128 images and labels from numpy seed 1."""
    if "batch" not in state:
        rs = np.random.RandomState(1)
        state["batch"] = (rs.rand(128, 3, 224, 224).astype("float32"),
                          rs.randint(0, 1000, (128,)).astype("float32"))
    return state["batch"]


def _train_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_train(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()

    # -- the main path: bf16, batch 128, 5 steps on one batch -------------
    net = _build_net(mx, arrays, False, "bfloat16", mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF)
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = _train_step(mx, net, trainer, loss_fn, x, y)
        losses.append(loss.detach().float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _bn_counts(BNF)
    conv = CF.LAUNCHES
    want = {k: 5 * BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * 5 * BN_PER_STEP
    ok_counts = all(counts[k] == n for k, n in want.items()) and conv == 0
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {}).update(
        {k: counts[k] for k in BN_KERNELS})
    state["train"] = lambda: _train_step(mx, net, trainer, loss_fn, x, y)
    emit({"phase": "train", "dtype": "bfloat16", "batch": 128, "steps": 5,
          "losses": losses, "launches": counts, "launches_wanted": want,
          "conv_fused_launches": conv,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "ok": ok_counts and ok_loss})
    if not ok_counts:
        raise AssertionError("training launches %s (conv_fused %d), want %s"
                             % (counts, conv, want))
    if not ok_loss:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)

    _f32_card_vs_cpu(torch, mx, arrays, x_np[:4], y_np[:4], loss_fn, False)


def _zero_codec(C):
    C.LAUNCHES_QUANTIZE = C.LAUNCHES_DEQUANTIZE = 0
    C.SEGMENTS_QUANTIZE = C.SEGMENTS_DEQUANTIZE = 0


def _compressed_kv(mx):
    """A local kvstore with 2-bit compression, as a user makes one."""
    kv = mx.kv.create("local")
    kv.set_gradient_compression(dict(KV_COMPRESSION))
    return kv


def phase_train_kv(torch, state):
    """Path E0: phase train's eager step with a compressed kvstore attached
    (every gradient pushed, compressed where it has at least the bound's
    elements, pulled back into param.grad(), then the SGD update)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import compression as C
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()

    # -- the main path: bf16, batch 128, 5 steps on one batch -------------
    net = _build_net(mx, arrays, False, "bfloat16", mx.gpu(0))
    kv = _compressed_kv(mx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD),
                               kvstore=kv)
    bound_n = kv._compression_params["size_lower_bound"]
    trainable = [p for p in trainer._params if p.grad_req != "null"]
    compressed = [p for p in trainable if p._tensor().numel() >= bound_n]
    elements = sum(p._tensor().numel() for p in compressed)
    derived = (len(trainable), len(compressed), elements)
    if derived != (KV_TRAINABLE, KV_COMPRESSED, KV_COMPRESSED_ELEMENTS):
        raise AssertionError("compressed parameters (trainable, compressed, "
                             "elements) %s, want %s" % (derived, (
                                 KV_TRAINABLE, KV_COMPRESSED,
                                 KV_COMPRESSED_ELEMENTS)))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF)
    _zero_codec(C)
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = _train_step(mx, net, trainer, loss_fn, x, y)
        losses.append(loss.detach().float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _bn_counts(BNF)
    conv = CF.LAUNCHES
    codec = {"quantize": C.LAUNCHES_QUANTIZE,
             "dequantize": C.LAUNCHES_DEQUANTIZE,
             "quantize_segments": C.SEGMENTS_QUANTIZE,
             "dequantize_segments": C.SEGMENTS_DEQUANTIZE}
    want = {k: 5 * BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * 5 * BN_PER_STEP
    # one grouped launch of each kernel per step, over every compressed key
    want_codec = {"quantize": 5, "dequantize": 5,
                  "quantize_segments": 5 * len(compressed),
                  "dequantize_segments": 5 * len(compressed)}
    ok_counts = all(counts[k] == n for k, n in want.items()) \
        and conv == 0 and codec == want_codec
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {}).update(
        {"compression." + k: n for k, n in codec.items()})
    state["train_kv"] = lambda: _train_step(mx, net, trainer, loss_fn, x, y)
    emit({"phase": "train_kv", "dtype": "bfloat16", "batch": 128,
          "steps": 5, "compression": KV_COMPRESSION,
          "size_lower_bound": bound_n, "trainable_params": len(trainable),
          "compressed_params": len(compressed),
          "compressed_elements": elements, "losses": losses,
          "launches": dict(counts, **codec), "conv_fused_launches": conv,
          "launches_wanted": dict(want, **want_codec),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "ok": ok_counts and ok_loss})
    if not ok_counts:
        raise AssertionError("compressed training launches %s %s (conv_fused "
                             "%d), want %s %s" % (counts, codec, conv, want,
                                                  want_codec))
    if not ok_loss:
        raise AssertionError("compressed training loss not finite and "
                             "falling: %s" % losses)

    _kv_pulled_check(torch, mx, net, trainer, loss_fn, x, y, bound_n)
    _kv_update_on_kvstore_check(torch, mx, arrays, x_np[:16], y_np[:16],
                                loss_fn)


def _kv_pulled_check(torch, mx, net, trainer, loss_fn, x, y, bound_n):
    """One more step with the pushes recorded (the Trainer pushes a list of
    every key): every compressed key's pulled gradient and new residual
    equal the plain codec run on the card on the same pushed gradient and
    residual, bit for bit; every other key's pulled gradient equals the
    pushed one."""
    from mxnet_tpu_torch.kernels import compression as C
    kv = trainer._kvstore
    thr = kv._compression_params["threshold"]
    pushed = {}
    push = kv.push

    def recording_push(key, value, priority=0):
        keys, vals = (key, value) if isinstance(key, list) \
            else ([key], [value])
        for k, v in zip(keys, vals):
            res = kv._compression_residuals.get(k)
            pushed[k] = (v.detach().clone(),
                         None if res is None else res.clone())
        return push(key, value, priority)
    kv.push = recording_push
    try:
        _train_step(mx, net, trainer, loss_fn, x, y)
    finally:
        del kv.push
    torch.cuda.synchronize()
    bad, n_comp, n_plain = [], 0, 0
    for p in trainer._params:
        if p.grad_req == "null":
            continue
        idx = trainer._param2idx[p.name]
        g, res = pushed[idx]
        if g.numel() >= bound_n:
            n_comp += 1
            flat = g.reshape(-1)
            rw, rr = C.quantize_2bit_reference(
                flat, torch.zeros_like(flat) if res is None else res, thr)
            want = C.dequantize_2bit_reference(rw, flat.numel(), thr) \
                .reshape(g.shape).to(g.dtype)
            ok = same_bits(torch, p._grad_tensor(), want) and same_bits(
                torch, kv._compression_residuals[idx], rr)
        else:
            n_plain += 1
            ok = same_bits(torch, p._grad_tensor(), g)
        if not ok:
            bad.append(p.name)
    emit({"phase": "train_kv", "check": "pulled gradients against the "
          "plain codec on the card", "compressed_keys": n_comp,
          "uncompressed_keys": n_plain, "bitwise": not bad,
          "failed": bad[:10], "ok": not bad})
    if bad:
        raise AssertionError("pulled gradients differ from the plain codec: "
                             "%s" % bad[:10])


def _kv_update_on_kvstore_check(torch, mx, arrays, x_np, y_np, loss_fn):
    """Two compressed bf16 steps with update_on_kvstore=True (the store's
    pickled copy of SGD updates the stored weights, the pull writes them)
    against two with False, from the same start: every weight bit for bit
    (cuDNN's deterministic algorithms, so that the gradients repeat)."""
    prev = _deterministic_cudnn(torch)
    weights = {}
    try:
        for on in (False, True):
            net = _build_net(mx, arrays, False, "bfloat16", mx.gpu(0))
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(SGD), kvstore=_compressed_kv(mx),
                                       update_on_kvstore=on)
            x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
            y = torch.from_numpy(y_np).cuda()
            for _ in range(2):
                _train_step(mx, net, trainer, loss_fn, x, y)
            if trainer._update_on_kvstore is not on:
                raise AssertionError("update_on_kvstore=%s not attached" % on)
            weights[on] = {k: p._tensor().detach().clone() for k, p in
                           net._collect_params_with_prefix().items()}
            del net, trainer
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    same = all(same_bits(torch, weights[True][k], weights[False][k])
               for k in weights[False])
    emit({"phase": "train_kv", "dtype": "bfloat16", "batch": len(x_np),
          "steps": 2, "update_on_kvstore_true_vs_false_bitwise": same,
          "ok": same})
    if not same:
        raise AssertionError("update_on_kvstore=True and False trained "
                             "different weights")


def _f32_card_vs_cpu(torch, mx, arrays, x_np, y_np, loss_fn, fuse,
                     opt=("sgd", SGD), phase=None):
    """One f32 training step (TF32 off) from the seed weights with the
    optimizer ``opt`` (name, parameters), the card against the port on the
    CPU; ``fuse=True`` runs the fused net through gluon.train_step with
    MXTPU_FUSED_APPLY=1.

    The gradients of this deep net at batch 4 are ill-conditioned: any two
    correct f32 implementations differ by several percent in some layers.
    So the card-vs-CPU gap of the gradients and updated weights must stay
    within twice the spread between two other correct f32 runs (and never
    needs to beat the stated bounds of TRAIN_RTOL). The two runs of a
    spread launch the same kernels, or none, so a wrong kernel cannot
    widen its own bound:

      fuse=False: the card with cuDNN on against the card with cuDNN off
        (PyTorch's own convolutions);
      fuse=True: the larger of that same spread of the unfused net, and
        the CPU's fused net against the CPU's unfused one (the fold's f32
        form against the BatchNorm's, both plain). With the fused net the
        3x3 convolutions run the conv_fused kernels whether cuDNN is on
        or off, so its own cuDNN spread moves only the 7x7 stem."""
    phase = phase or ("train_fused" if fuse else "train")
    variants = [("card", mx.gpu(0), True, fuse), ("cpu", mx.cpu(), True, fuse)]
    witnesses = []
    if fuse:
        variants += [("cpu_unfused", mx.cpu(), True, False),
                     ("card_unfused", mx.gpu(0), True, False)]
        witnesses.append(("cpu", "cpu_unfused"))
    unfused = "card_unfused" if fuse else "card"
    variants.append((unfused + "_native_conv", mx.gpu(0), False, False))
    witnesses.append((unfused, unfused + "_native_conv"))
    runs = {}
    with mx.precision.matmul_precision("float32"):
        for name, ctx, cudnn, f in variants:
            prev = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = cudnn
            try:
                runs[name] = _one_step(torch, mx, arrays, ctx, x_np, y_np,
                                       loss_fn, f, "float32", opt=opt)
            finally:
                torch.backends.cudnn.enabled = prev
    gap = {w: _max_rel(runs["card"], runs["cpu"], w) for w in TRAIN_RTOL}
    spreads = {"%s_vs_%s_max_rel" % (a, b): {
        w: _max_rel(runs[a], runs[b], w) for w in TRAIN_RTOL}
        for a, b in witnesses}
    bound = {"loss": TRAIN_RTOL["loss"]}
    for w in ("grad", "param"):
        bound[w] = max([TRAIN_RTOL[w]]
                       + [2.0 * s[w][0] for s in spreads.values()])
    ok = all(gap[w][0] <= bound[w] for w in TRAIN_RTOL)
    emit(dict({"phase": phase, "dtype": "float32", "batch": len(x_np),
               "optimizer": opt[0], "card_vs_cpu_max_rel": gap}, **spreads,
              bound_rel=bound, stated_rel=TRAIN_RTOL,
              loss=runs["card"]["loss"].tolist(), ok=ok))
    if not ok:
        raise AssertionError("f32 training step (fuse=%s), card vs CPU: %s "
                             "over %s" % (fuse, gap, bound))


def _one_step(torch, mx, arrays, ctx, x_np, y_np, loss_fn, fuse, dtype,
              steps=1, opt=("sgd", SGD), **trainer_kw):
    """``steps`` training steps from the seed weights on ``ctx`` with the
    optimizer ``opt`` (name, parameters): the last per-sample loss, every
    gradient, and every parameter and running statistic after the update,
    on the host. ``fuse=False`` runs the eager record/backward/
    Trainer.step (``trainer_kw`` to the Trainer: a kvstore); ``fuse=True``
    the hybridized fused net through gluon.train_step."""
    net = _build_net(mx, arrays, fuse, dtype, ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                               **trainer_kw)
    dev = ctx.device
    x = torch.from_numpy(x_np).to(dev, getattr(torch, dtype))
    y = torch.from_numpy(y_np).to(dev)
    if fuse:
        net.hybridize()
        step = mx.gluon.train_step(net, loss_fn, trainer)
    for _ in range(steps):
        if fuse:
            loss = step(x, y)
            if step.last_mode != "fused":
                raise AssertionError("train_step ran %r" % step.last_mode)
        else:
            loss = _train_step(mx, net, trainer, loss_fn, x, y)
    params = net._collect_params_with_prefix()
    return {"loss": loss.detach().cpu(),
            "grad": {k: p._grad_tensor().cpu() for k, p in params.items()
                     if p.grad_req != "null"},
            "param": {k: p._tensor().detach().cpu()
                      for k, p in params.items()}}


def _max_rel(a, b, what):
    """Largest |a - b| / max|b| over the tensors of ``what``, and where."""
    pairs = [("loss", a["loss"], b["loss"])] if what == "loss" \
        else [(k, a[what][k], b[what][k]) for k in b[what]]
    worst = (0.0, None)
    for key, u, v in pairs:
        rel = (u - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
        worst = max(worst, (rel, key), key=lambda t: t[0])
    return worst


def _set_fused_apply(value):
    """Set MXTPU_FUSED_APPLY; returns the previous value (None if unset)."""
    prev = os.environ.get("MXTPU_FUSED_APPLY")
    if value is None:
        os.environ.pop("MXTPU_FUSED_APPLY", None)
    else:
        os.environ["MXTPU_FUSED_APPLY"] = value
    return prev


def phase_train_fused(torch, state):
    prev = _set_fused_apply("1")
    try:
        _train_fused(torch, state)
    finally:
        _set_fused_apply(prev)


def _train_fused(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()

    # -- the main path: fuse=True, bf16, batch 128, 5 fused steps ----------
    net = _build_net(mx, arrays, True, "bfloat16", mx.gpu(0))
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    step = mx.gluon.train_step(net, loss_fn, trainer)
    # the trainable weights in the order the step packs them
    all_params, train_pos, _ = step._param_split()
    trainable = [all_params[pos]._tensor() for pos in train_pos]
    buckets = len(OA.bucketize(trainable))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF, OA)
    losses, modes = [], []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = step(x, y)
        modes.append(step.last_mode)
        losses.append(loss.float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = _conv_counts(CF)
    bn = _bn_counts(BNF)
    apply_n = OA.LAUNCHES
    want_conv = {k: 5 * FUSED_PER_STEP
                 for k in ("fwd", "bwd_dx", "bwd_dw", "finalize", "reduce")}
    want_bn = {k: 5 * BN_FUSED_NET_PER_STEP for k in BN_KERNELS}
    want_bn["finalize"] = 2 * 5 * BN_FUSED_NET_PER_STEP
    ok_counts = all(conv[k] == n for k, n in want_conv.items()) \
        and all(bn[k] == n for k, n in want_bn.items()) \
        and apply_n == 5 * buckets
    ok_mode = all(m == "fused" for m in modes)
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {}).update(
        {"conv_fused." + k: conv[k] for k in CONV_BWD})
    state["launches"]["optimizer_apply"] = apply_n

    def fused_step():
        prev = _set_fused_apply("1")
        try:
            step(x, y)
        finally:
            _set_fused_apply(prev)
    state["train_fused"] = fused_step
    state["apply_buckets"] = buckets
    emit({"phase": "train_fused", "dtype": "bfloat16", "batch": 128,
          "steps": 5, "losses": losses, "last_modes": modes,
          "trainable_tensors": len(trainable),
          "trainable_elements": sum(w.numel() for w in trainable),
          "buckets": buckets,
          "launches": {"conv_fused": conv, "batchnorm_fused": bn,
                       "optimizer_apply": apply_n},
          "launches_wanted": {"conv_fused": want_conv,
                              "batchnorm_fused": want_bn,
                              "optimizer_apply": 5 * buckets},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "ok": ok_counts and ok_mode and ok_loss})
    if not ok_counts:
        raise AssertionError("fused training launches conv %s, bn %s, apply "
                             "%d; want %s, %s, %d" % (conv, bn, apply_n,
                                                      want_conv, want_bn,
                                                      5 * buckets))
    if not ok_mode:
        raise AssertionError("train_step modes %s, want fused" % modes)
    if not ok_loss:
        raise AssertionError("fused training loss not finite and falling: "
                             "%s" % losses)

    # -- f32, TF32 off: one step at batch 4, the card against the CPU -----
    _f32_card_vs_cpu(torch, mx, arrays, x_np[:4], y_np[:4], loss_fn, True)

    # -- MXTPU_FUSED_APPLY=0 against =1: two bf16 steps, same weights -----
    _fused_apply_0_vs_1(torch, mx, arrays, x_np, y_np, loss_fn, ("sgd", SGD),
                        "train_fused")


def _deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms on (benchmark off), so that two runs'
    gradients are reproducible; returns the previous flags."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return prev


def _fused_apply_0_vs_1(torch, mx, arrays, x_np, y_np, loss_fn, opt, phase):
    """Two bf16 fused steps at batch 16 with MXTPU_FUSED_APPLY=0 against two
    with =1, from the same weights: the updated weights equal bit for bit
    (cuDNN's deterministic algorithms, so that any difference is the update
    phase's)."""
    prev = _deterministic_cudnn(torch)
    runs = {}
    try:
        for mode in ("0", "1"):
            _set_fused_apply(mode)
            runs[mode] = _one_step(torch, mx, arrays, mx.gpu(0), x_np[:16],
                                   y_np[:16], loss_fn, True, "bfloat16",
                                   steps=2, opt=opt)
    finally:
        _set_fused_apply("1")
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    same = {w: all(same_bits(torch, runs["0"][w][k], runs["1"][w][k])
                   for k in runs["1"][w]) for w in ("grad", "param")}
    ok = same["param"]
    emit({"phase": phase, "dtype": "bfloat16", "batch": 16, "steps": 2,
          "optimizer": opt[0], "fused_apply_0_vs_1_bitwise": same, "ok": ok})
    if not ok:
        raise AssertionError("MXTPU_FUSED_APPLY=0 and =1 updated the "
                             "weights differently (%s): %s" % (opt[0], same))


def phase_train_adam(torch, state):
    prev = _set_fused_apply("1")
    try:
        _train_adam(torch, state)
    finally:
        _set_fused_apply(prev)


def _train_adam(torch, state):
    """Path Adam: phase train_fused's fused step with Adam (ADAM) in place
    of SGD, MXTPU_FUSED_APPLY=1: one packed Adam launch per bucket."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()

    # -- the main path: fuse=True, bf16, batch 128, 5 fused Adam steps -----
    net = _build_net(mx, arrays, True, "bfloat16", mx.gpu(0))
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
    step = mx.gluon.train_step(net, loss_fn, trainer)
    all_params, train_pos, _ = step._param_split()
    trainable = [all_params[pos]._tensor() for pos in train_pos]
    buckets = len(OA.bucketize(trainable))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF, OA)
    losses, modes = [], []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = step(x, y)
        modes.append(step.last_mode)
        losses.append(loss.float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = _conv_counts(CF)
    bn = _bn_counts(BNF)
    apply_n = OA.LAUNCHES
    want_conv = {k: 5 * FUSED_PER_STEP
                 for k in ("fwd", "bwd_dx", "bwd_dw", "finalize", "reduce")}
    want_bn = {k: 5 * BN_FUSED_NET_PER_STEP for k in BN_KERNELS}
    want_bn["finalize"] = 2 * 5 * BN_FUSED_NET_PER_STEP
    ok_counts = all(conv[k] == n for k, n in want_conv.items()) \
        and all(bn[k] == n for k, n in want_bn.items()) \
        and apply_n == 5 * buckets
    ok_mode = all(m == "fused" for m in modes)
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {})["optimizer_apply.adam"] = apply_n

    def adam_step():
        prev = _set_fused_apply("1")
        try:
            step(x, y)
        finally:
            _set_fused_apply(prev)
    state["train_adam"] = adam_step
    state["adam_buckets"] = buckets
    emit({"phase": "train_adam", "dtype": "bfloat16", "batch": 128,
          "steps": 5, "optimizer": ADAM, "losses": losses,
          "last_modes": modes, "trainable_tensors": len(trainable),
          "trainable_elements": sum(w.numel() for w in trainable),
          "buckets": buckets,
          "launches": {"conv_fused": conv, "batchnorm_fused": bn,
                       "optimizer_apply.adam": apply_n},
          "launches_wanted": {"conv_fused": want_conv,
                              "batchnorm_fused": want_bn,
                              "optimizer_apply.adam": 5 * buckets},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "ok": ok_counts and ok_mode and ok_loss})
    if not ok_counts:
        raise AssertionError("fused Adam training launches conv %s, bn %s, "
                             "apply %d; want %s, %s, %d"
                             % (conv, bn, apply_n, want_conv, want_bn,
                                5 * buckets))
    if not ok_mode:
        raise AssertionError("train_step modes %s, want fused" % modes)
    if not ok_loss:
        raise AssertionError("fused Adam training loss not finite and "
                             "falling: %s" % losses)

    _fused_apply_0_vs_1(torch, mx, arrays, x_np, y_np, loss_fn,
                        ("adam", ADAM), "train_adam")
    # -- the eager Trainer.step with Adam, f32: the card against the CPU ---
    _f32_card_vs_cpu(torch, mx, arrays, x_np[:4], y_np[:4], loss_fn, False,
                     opt=("adam", ADAM), phase="train_adam")


def _sharded_step(mx, torch, net, opt, device, remat_policy=None,
                  loss_fn=None):
    """bench_resnet's construction: a one-device mesh, data_parallel and
    ShardedTrainStep (SoftmaxCrossEntropyLoss unless ``loss_fn``)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import (ShardedTrainStep, create_mesh,
                                          data_parallel)
    mesh = create_mesh(devices=[device], dp=1)
    return ShardedTrainStep(net, loss_fn or SoftmaxCrossEntropyLoss(),
                            mx.optimizer.create(opt[0], **opt[1]),
                            strategy=data_parallel(mesh),
                            remat_policy=remat_policy)


def _sharded_want(fused_links, remat):
    """Launches per step of rows 1-7 on the sharded path: each fused link
    launches the three conv_fused kernels (and the finalize and reduce
    launches) once; every other BatchNorm the four BatchNorm kernels once
    each, with a finalize launch after each fold. Under remat the backward
    recomputes each region's forward: the fused conv's output is kept (one
    dispatcher op, tagged), but a training BatchNorm is an autograd
    Function that launches its statistics and apply kernels inside, so it
    runs again (the statistics it returns are kept, the normalized output
    is not, and the Function recomputes both)."""
    bn = BN_PER_STEP - fused_links
    conv = {k: fused_links
            for k in ("fwd", "bwd_dx", "bwd_dw", "finalize", "reduce")}
    fwd = 2 if remat else 1
    bnw = {"stats": fwd * bn, "apply": fwd * bn, "bwd_reduce": bn,
           "bwd_dx": bn, "finalize": fwd * bn + bn}
    return conv, bnw


def phase_train_sharded(torch, state):
    """Path train_sharded: bench_resnet's parallel.ShardedTrainStep on a
    one-device mesh, in bf16 at batch 128 (SHARDED), then the narrow f32
    step card vs CPU and every optimizer card vs CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    x = torch.from_numpy(x_np).to(torch.bfloat16)
    y = torch.from_numpy(y_np)
    dev = mx.gpu(0).device
    runs = {}
    for name in ("sharded_auto", "sharded_remat", "sharded"):
        fuse, remat = SHARDED[name]
        net = _build_net(mx, arrays, fuse, "bfloat16", mx.gpu(0))
        links = sum(1 for m in net.modules() if getattr(m, "_fuse", False))
        step = _sharded_step(mx, torch, net, ("sgd", SGD), dev, remat)
        xd, yd = step.place_batch(x, y)
        # 2 warm steps, with cuDNN's deterministic algorithms: the
        # fuse="auto" pair is compared after them, remat against not
        prev = _deterministic_cudnn(torch)
        try:
            warm = [step.step(xd, yd) for _ in range(2)]
            torch.cuda.synchronize()
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = prev
        snap = {k: v.detach().clone() for k, v in step.params.items()} \
            if fuse == "auto" else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(BNF, CF)
        t0 = time.perf_counter()
        out = [step.step(xd, yd) for _ in range(5)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(v) for v in out]
        peak = torch.cuda.max_memory_allocated()
        conv, bn = _conv_counts(CF), _bn_counts(BNF)
        want_conv, want_bn = _sharded_want(links, remat)
        ok_counts = links == (FUSED_PER_STEP if fuse is True
                              else SHARDED_AUTO_FUSED) \
            and all(conv[k] == 5 * n for k, n in want_conv.items()) \
            and all(bn[k] == 5 * n for k, n in want_bn.items())
        ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
        runs[name] = {"warm_losses": [float(v) for v in warm],
                      "snap": snap, "peak": peak}
        emit({"phase": "train_sharded", "config": name, "fuse": fuse,
              "remat_policy": remat, "dtype": "bfloat16", "batch": 128,
              "steps": 5, "losses": losses,
              "launches": {"conv_fused": conv, "batchnorm_fused": bn},
              "launches_wanted_per_step": {"conv_fused": want_conv,
                                           "batchnorm_fused": want_bn},
              "fused_links": links,
              "max_memory_allocated_bytes": peak, "wall_s": wall,
              "ok": ok_counts and ok_loss})
        if not ok_counts:
            raise AssertionError(
                "%s launches conv %s, bn %s over 5 steps (%d fused links); "
                "want per step %s, %s" % (name, conv, bn, links, want_conv,
                                          want_bn))
        if not ok_loss:
            raise AssertionError("%s loss not finite and falling: %s"
                                 % (name, losses))
        if name != "sharded_auto":
            state.setdefault("launches_sharded", {})[name] = {
                "conv_fused": conv["fwd"],
                "conv_fused.bwd_dx": conv["bwd_dx"],
                "conv_fused.bwd_dw": conv["bwd_dw"],
                **{k: bn[k] for k in BN_KERNELS}}
            state[name] = (step, xd, yd, peak)
        del net
    _sharded_remat_checks(torch, runs)
    torch.cuda.empty_cache()
    _sharded_narrow_card_vs_cpu(torch, mx)
    _sharded_optimizers_card_vs_cpu(torch, mx)


def _sharded_remat_checks(torch, runs):
    """Remat against no remat, fuse="auto", from the same weights: lower
    peak memory over the timed steps, and after the two warm steps (cuDNN
    deterministic) the same losses, weights and running statistics bit
    for bit."""
    a, r = runs["sharded_auto"], runs["sharded_remat"]
    same = a["warm_losses"] == r["warm_losses"] and all(
        same_bits(torch, a["snap"][k], r["snap"][k]) for k in a["snap"])
    ok_mem = r["peak"] < a["peak"]
    emit({"phase": "train_sharded", "check": "remat_vs_no_remat",
          "fuse": "auto", "warm_losses": {"remat": r["warm_losses"],
                                          "no_remat": a["warm_losses"]},
          "bitwise_after_2_steps": same,
          "max_memory_allocated_bytes": {"remat": r["peak"],
                                         "no_remat": a["peak"]},
          "ok": same and ok_mem})
    if not same:
        raise AssertionError("remat_policy='conv_outs' trained other bits "
                             "than no remat")
    if not ok_mem:
        raise AssertionError("remat peak memory %d not below no remat's %d"
                             % (r["peak"], a["peak"]))


def _narrow_net(mx, torch, fuse, ctx, arrays=None):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as R
    net = R.ResNetV1(R.BottleneckV1, *NARROW, classes=10, thumbnail=True,
                     layout="NHWC", fuse=fuse)
    net.initialize(ctx=ctx)
    net(torch.zeros(1, 3, 32, 32, device=ctx.device))
    if arrays is None:
        arrays = mx.convert.random_numpy_params(
            mx.convert.param_shapes(net), seed=3)
    mx.convert.load_numpy_params(net, arrays)
    return net, arrays


def _sharded_narrow_card_vs_cpu(torch, mx):
    """Two f32 ShardedTrainStep steps of the narrow ResNet (fuse=True, and
    fuse=False with remat), TF32 off, the card against the CPU from the
    same weights: NARROW_RTOL."""
    rs = np.random.RandomState(1)
    x = rs.rand(4, 3, 32, 32).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (4,)).astype("float32")
    with mx.precision.matmul_precision("float32"):
        for fuse, remat in ((True, None), (False, "conv_outs")):
            got = {}
            arrays = None
            for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
                net, arrays = _narrow_net(mx, torch, fuse, ctx, arrays)
                step = _sharded_step(mx, torch, net, ("sgd", SGD),
                                     ctx.device, remat)
                losses = [step(x, y) for _ in range(2)]
                got[where] = (losses, {k: v.detach().float().cpu()
                                       for k, v in step.params.items()})
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(got["card"][0], got["cpu"][0]))
            param_rel = max(
                (((got["card"][1][k] - v).abs().max()
                  / v.abs().max().clamp_min(1e-30)).item(), k)
                for k, v in got["cpu"][1].items())
            ok = loss_rel <= NARROW_RTOL["loss"] \
                and param_rel[0] <= NARROW_RTOL["param"]
            emit({"phase": "train_sharded", "check": "narrow_f32_card_vs_cpu",
                  "fuse": fuse, "remat_policy": remat, "batch": 4, "steps": 2,
                  "loss_max_rel": loss_rel, "param_max_rel": param_rel,
                  "bound_rel": NARROW_RTOL, "ok": ok})
            if not ok:
                raise AssertionError("narrow f32 sharded step card vs CPU "
                                     "(fuse=%s, remat=%s): loss %g, param "
                                     "%s" % (fuse, remat, loss_rel,
                                             param_rel))


def _opt_leaves(st):
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [a for s in st for a in _opt_leaves(s)]
    return [st]


def _sharded_optimizers_card_vs_cpu(torch, mx):
    """SHARDED_OPTIMIZERS through ShardedTrainStep, card against CPU (see
    the constant's comment)."""
    rs = np.random.RandomState(5)
    w0 = {"weight": rs.uniform(-0.5, 0.5, (8, 16)).astype("float32"),
          "bias": rs.uniform(-0.1, 0.1, (8,)).astype("float32")}
    batches = [(rs.randn(1, 16).astype("float32"),
                rs.randn(1, 8).astype("float32")) for _ in range(3)]

    def linear(out, y):
        return (out * y).sum(-1)
    worst = {}
    for name, kw in SHARDED_OPTIMIZERS.items():
        for dtype, mp in (("float32", False), ("bfloat16", True)):
            got = {}
            for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
                net = mx.gluon.nn.Dense(8, in_units=16)
                net.initialize(ctx=ctx)
                mx.convert.load_numpy_params(net, w0)
                net.cast(dtype)
                mx.random.seed(0)              # SGLD's noise
                step = _sharded_step(
                    mx, torch, net, (name, dict(kw, multi_precision=mp)),
                    ctx.device, loss_fn=linear)
                for bx, by in batches:
                    step.step(torch.from_numpy(bx).to(getattr(torch, dtype)),
                              torch.from_numpy(by).to(getattr(torch, dtype)))
                got[where] = [t.detach().float().cpu() for path in
                              step._param_paths for t in
                              [step.params[path]]
                              + _opt_leaves(step.opt_states[path])]
            errs = [((c - r).abs().max() / r.abs().max().clamp_min(1e-30))
                    .item() for c, r in zip(got["card"], got["cpu"])]
            # the bf16 weights lead each path's list: one bf16 ulp for them
            n = len(got["cpu"]) // 2
            bounds = [OPT_BF16_RTOL if mp and i in (0, n) else OPT_RTOL
                      for i in range(len(errs))]
            key = "%s/%s" % (name, dtype)
            worst[key] = max(errs)
            if any(e > b for e, b in zip(errs, bounds)):
                raise AssertionError("ShardedTrainStep %s card vs CPU: "
                                     "errors %s over bounds %s"
                                     % (key, errs, bounds))
    emit({"phase": "train_sharded", "check": "optimizers_card_vs_cpu",
          "optimizers": len(SHARDED_OPTIMIZERS), "steps": 3,
          "bound_rel": {"f32": OPT_RTOL, "bf16_weights": OPT_BF16_RTOL},
          "max_rel": worst, "ok": True})


# -- the NDArray front end: serving, training and the checkpoint path
#    through mx.nd ----------------------------------------------------------

ND_STEPS = 2          # NDArray-fed eager steps held against tensor-fed ones
ND_TIMED = 3          # steps per timed turn (tensor, NDArray, NDArray, tensor)


def _params_equal(torch, a, b):
    """The structural names whose tensors differ between nets a and b."""
    pb = b._collect_params_with_prefix()
    return [k for k, p in a._collect_params_with_prefix().items()
            if not torch.equal(p._tensor(), pb[k]._tensor())]


def _nd_step(mx, net, trainer, loss_fn, x, y):
    """One eager step; x and y NDArrays or tensors alike."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_ndarray(torch, state):
    """ResNet-50 served, trained, saved and reloaded through mx.nd (the
    module docstring, phase 5d)."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.ndarray import ndarray as NDA

    prev = _deterministic_cudnn(torch)
    arrays = _arrays(mx, state)
    gpu = mx.gpu(0)
    failures = []

    # -- 1. serving: 4 requests of 32 as NDArrays on gpu(0) ---------------
    rs = np.random.RandomState(1)
    requests = [rs.rand(32, 3, 224, 224).astype("float32") for _ in range(4)]
    net = _build_net(mx, arrays, True, "bfloat16", gpu)
    xs = [mx.nd.array(r, ctx=gpu, dtype="bfloat16") for r in requests]
    torch.cuda.synchronize()
    CF.LAUNCHES = 0
    outs = [net(x) for x in xs]
    torch.cuda.synchronize()
    serve_launches = CF.LAUNCHES
    same = 0
    for r, x, out in zip(requests, xs, outs):
        ok = isinstance(out, mx.nd.NDArray) and out.context == gpu \
            and out.shape == (32, 1000) and str(out.dtype) in (
                "bfloat16", "torch.bfloat16")
        ref = net(torch.from_numpy(r).to("cuda", torch.bfloat16))
        same += int(ok and same_bits(torch, out._data, ref))
    ok_serve = same == len(requests) and serve_launches == 16 * len(xs)
    emit({"phase": "ndarray", "part": "serve", "dtype": "bfloat16",
          "requests": len(xs), "batch": 32, "launches": serve_launches,
          "launches_wanted": 16 * len(xs), "same_bits_as_tensor": same,
          "ml_dtypes": NDA._ml_dtypes is not None, "ok": ok_serve})
    if not ok_serve:
        failures.append("serve: %d of %d NDArray answers with the tensor "
                        "bits, %d conv_fused launches"
                        % (same, len(xs), serve_launches))
    del net, outs

    # -- 2. training: 2 eager steps fed NDArrays against tensors ----------
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()
    net = _build_net(mx, arrays, False, "bfloat16", gpu)
    ref = _build_net(mx, arrays, False, "bfloat16", gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    rtrainer = mx.gluon.Trainer(ref.collect_params(), "sgd", dict(SGD))
    xn = mx.nd.array(x_np, ctx=gpu, dtype="bfloat16")
    yn = mx.nd.array(y_np, ctx=gpu)
    xt = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    yt = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    _zero_counts(BNF, CF)
    losses = []
    for _ in range(ND_STEPS):
        loss = _nd_step(mx, net, trainer, loss_fn, xn, yn)
        losses.append(float(loss.mean().asscalar()))
    torch.cuda.synchronize()
    counts = _bn_counts(BNF)
    conv = CF.LAUNCHES
    for _ in range(ND_STEPS):
        _nd_step(mx, ref, rtrainer, loss_fn, xt, yt)
    torch.cuda.synchronize()
    differ = _params_equal(torch, net, ref)
    want = {k: ND_STEPS * BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * ND_STEPS * BN_PER_STEP
    ok_counts = all(counts[k] == n for k, n in want.items()) and conv == 0
    ok_train = ok_counts and not differ and isinstance(loss, mx.nd.NDArray) \
        and all(np.isfinite(losses))
    state.setdefault("launches", {})["ndarray"] = {
        "conv_fused": serve_launches,
        **{k: counts[k] for k in BN_KERNELS}}
    emit({"phase": "ndarray", "part": "train", "dtype": "bfloat16",
          "batch": 128, "steps": ND_STEPS, "losses": losses,
          "launches": counts, "launches_wanted": want,
          "conv_fused_launches": conv,
          "weights_differing_from_tensor_fed": differ[:5],
          "n_differing": len(differ), "ok": ok_train})
    if not ok_train:
        failures.append("train: launches %s (conv_fused %d), want %s; %d "
                        "weights differ from the tensor-fed steps"
                        % (counts, conv, want, len(differ)))

    # -- 3. the checkpoint round trip -------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nd_") as tmp:
        fparams = os.path.join(tmp, "resnet50.params")
        fstates = os.path.join(tmp, "resnet50.states")
        fcpu = os.path.join(tmp, "resnet50_cpu.params")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.save_parameters(fparams)
        save_s = time.perf_counter() - t0
        trainer.save_states(fstates)
        cpu_arrays = {k: p.data().as_in_context(mx.cpu()) for k, p in
                      net._collect_params_with_prefix().items()}
        mx.nd.save(fcpu, cpu_arrays)
        n_values = sum(a.size for a in cpu_arrays.values())
        size = os.path.getsize(fparams)
        with open(fparams, "rb") as a, open(fcpu, "rb") as b:
            same_file = a.read() == b.read()
        del cpu_arrays
        net2 = resnet50_v1(layout="NHWC", fuse=False)
        net2.initialize(ctx=gpu)
        net2.cast("bfloat16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net2.load_parameters(fparams, ctx=mx.gpu(0))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        trainer2 = mx.gluon.Trainer(net2.collect_params(), "sgd", dict(SGD))
        trainer2.load_states(fstates)
    reload_differ = _params_equal(torch, net, net2)
    f_a, f_b = net(xs[0]), net2(xs[0])
    same_fwd = same_bits(torch, f_a._data, f_b._data)
    _nd_step(mx, net, trainer, loss_fn, xn, yn)
    _nd_step(mx, net2, trainer2, loss_fn, xn, yn)
    torch.cuda.synchronize()
    step3_differ = _params_equal(torch, net, net2)
    ok_ckpt = same_file and same_fwd and not reload_differ \
        and not step3_differ
    emit({"phase": "ndarray", "part": "checkpoint", "file_bytes": size,
          "values": n_values, "same_bytes_as_cpu_save": same_file,
          "reloaded_weights_differing": len(reload_differ),
          "reloaded_b32_forward_same_bits": same_fwd,
          "third_step_weights_differing": len(step3_differ),
          "save_parameters_s": save_s, "load_parameters_s": load_s,
          "ok": ok_ckpt})
    if not ok_ckpt:
        failures.append("checkpoint: same bytes %s, reloaded forward bits "
                        "%s, %d / %d weights differ after reload / step 3"
                        % (same_file, same_fwd, len(reload_differ),
                           len(step3_differ)))
    del net2, trainer2, f_a, f_b

    # -- 4. host ms per eager step, tensor-fed and NDArray-fed in turns ---
    turns = []
    for kind in ("tensor", "ndarray", "ndarray", "tensor"):
        m, tr, x, y = (ref, rtrainer, xt, yt) if kind == "tensor" else \
            (net, trainer, xn, yn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ND_TIMED):
            _nd_step(mx, m, tr, loss_fn, x, y)
        torch.cuda.synchronize()
        turns.append((kind, (time.perf_counter() - t0) * 1e3 / ND_TIMED))
    tensor_ms = [ms for k, ms in turns if k == "tensor"]
    nd_ms = [ms for k, ms in turns if k == "ndarray"]
    spread = max(tensor_ms) - min(tensor_ms)
    cost = sum(nd_ms) / 2 - sum(tensor_ms) / 2
    emit({"phase": "ndarray", "part": "time", "smi": state["smi"],
          "turns_ms_per_step": turns, "steps_per_turn": ND_TIMED,
          "ndarray_minus_tensor_ms": cost, "tensor_spread_ms": spread,
          "within_tensor_spread": cost <= spread,
          "save_parameters_s": save_s, "load_parameters_s": load_s})
    state["ndarray_timing"] = {"turns": turns, "save_s": save_s,
                               "load_s": load_s}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        prev
    if failures:
        raise AssertionError("phase ndarray: " + "; ".join(failures))


# -- the vision model zoo: serving every family, ResNet-50 V2 fused training
#    on rows 4-8, VGG-16 with its Dropouts, DenseNet-121 ----------------------

# Serving (phase zoo, part a): each family at its published widths, 1000
# classes, random weights from numpy seed 0 (convert.random_numpy_params),
# 2 requests of 32 images (numpy seed 1) in f32 with TF32 off. The logits of
# the first 2 images against the port on the CPU within ZOO_LOGIT_RTOL of
# their largest magnitude: f32 with TF32 off on both sides, so only the
# summation order of the convolutions differs (phase serve's f32 bound).
ZOO_SERVE = [("alexnet", 224), ("vgg16_bn", 224), ("densenet121", 224),
             ("squeezenet1.1", 224), ("inceptionv3", 299),
             ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
             ("resnet50_v2", 224)]
ZOO_BATCH = 32
ZOO_REQUESTS = 2
ZOO_LOGIT_RTOL = 1e-4
# ResNet-50 V2 training (part b): NHWC, bf16, batch 128, SGD, 5 steps
# through gluon.train_step with MXTPU_FUSED_APPLY=1. 51 BatchNorms, all
# channels-last: each runs rows 4 and 5 once per forward; the backward runs
# rows 6 and 7 for every one but the image's (scale=False, center=False,
# the input needs no gradient), and each fold its finalize launch.
V2_BN = 1 + 1 + 3 * 16 + 1
V2_BN_BWD = V2_BN - 1
V2_C3_R = 128 * 224 * 224
# VGG-16 (part c): bf16 NCHW, batch 64, 3 eager Trainer steps. Each of its
# two Dropouts (rate 0.5) keeps a share of the nonzero entries within
# ZOO_DROPOUT_SIGMAS standard errors of 0.5, every kept one x / 0.5.
ZOO_DROPOUT_SIGMAS = 6.0
ZOO_TRAIN_BATCH = 64


def _zoo_net(mx, torch, name, ctx, size, arrays=None, **kw):
    """get_model(name) on ctx with weights from numpy seed 0 (or
    ``arrays``, which give the deferred shapes): without ``arrays`` a
    first forward on one image finishes the deferred shapes."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model(name, **kw)
    net.initialize(ctx=ctx)
    if arrays is None:
        net(torch.zeros(1, 3, size, size, device=ctx.device))
        arrays = mx.convert.random_numpy_params(
            mx.convert.param_shapes(net), seed=0)
    mx.convert.load_numpy_params(net, arrays)
    return net, arrays


def _zoo_serve(torch, mx, state):
    gpu = mx.gpu(0)
    results = {}
    failures = []
    with mx.precision.matmul_precision("float32"):
        for name, size in ZOO_SERVE:
            rs = np.random.RandomState(1)
            reqs = [rs.rand(ZOO_BATCH, 3, size, size).astype("float32")
                    for _ in range(ZOO_REQUESTS)]
            net, arrays = _zoo_net(mx, torch, name, gpu, size)
            outs = []
            t0 = time.perf_counter()
            for req in reqs:
                outs.append(net(torch.from_numpy(req).cuda()))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ok = all(tuple(o.shape) == (ZOO_BATCH, 1000)
                     and bool(torch.isfinite(o).all().item()) for o in outs)
            cpu_net, _ = _zoo_net(mx, torch, name, mx.cpu(), size, arrays)
            ref = cpu_net(torch.from_numpy(reqs[0][:2]))
            err = (outs[0][:2].cpu() - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = ok and err <= ZOO_LOGIT_RTOL * scale and scale > 0
            x = torch.from_numpy(reqs[0]).cuda()
            fwd = lambda: net(x)                          # noqa: E731
            dev_ms = device_busy_ms(torch, fwd, 3)
            wall_ms = host_ms(torch, fwd, 3)
            results[name] = {
                "input": [ZOO_BATCH, 3, size, size],
                "parameters": sum(int(np.prod(a.shape))
                                  for a in arrays.values()),
                "max_abs_diff_vs_cpu_port": err, "logit_max_abs": scale,
                "tolerance": ZOO_LOGIT_RTOL * scale,
                "device_busy_ms": dev_ms, "wall_ms": wall_ms,
                "images_per_sec": ZOO_BATCH * 1e3 / wall_ms,
                "images_per_sec_device": ZOO_BATCH * 1e3 / dev_ms,
                "device_idle_share": max(0.0, 1.0 - dev_ms / wall_ms),
                "first_requests_s": first_s, "ok": ok}
            emit(dict({"phase": "zoo", "part": "serve", "model": name,
                       "dtype": "float32", "tf32": False,
                       "requests": ZOO_REQUESTS}, **results[name]))
            if not ok:
                failures.append(name)
            del net, cpu_net, outs, x, fwd
            torch.cuda.empty_cache()
    state["zoo_serve"] = results
    if failures:
        raise AssertionError("zoo serving out of tolerance: %s" % failures)


def _c3_check(torch):
    """Rows 4-7 at ResNet-50 V2's input BatchNorm: C = 3, R = 128 x 224 x
    224, bf16, on the kernels' non-TMA route, against their plain versions
    (the forward bit for bit, the backward within BN_BWD_RTOL; the folds
    also their own second launch)."""
    x2, g, b, dy = bn_case(torch, V2_C3_R, 3, torch.bfloat16, seed=500)
    res = bn_check(torch, x2, g, b, dy, None)
    out = {k: {"ok": v[0], "max_abs_err": v[1], "ref_max_abs": v[2],
               "bitwise_share": v[3]} for k, v in res.items()}
    emit({"phase": "zoo", "check": "batchnorm_c3", "R": V2_C3_R, "C": 3,
          "dtype": "bfloat16", "results": out})
    del x2, g, b, dy
    torch.cuda.empty_cache()
    bad = [k for k, v in res.items() if not v[0]]
    if bad:
        raise AssertionError("batchnorm_fused at C = 3, R = %d disagrees "
                             "with its plain version: %s" % (V2_C3_R, bad))
    return out


def _v2_net(mx, torch, ctx, dtype, layers=None, size=224, arrays=None):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as R
    if layers is None:
        net = R.resnet50_v2(layout="NHWC")
    else:
        net = R.ResNetV2(R.BottleneckV2, *layers, classes=10, layout="NHWC")
    net.initialize(ctx=ctx)
    if arrays is None:
        net(torch.zeros(1, 3, size, size, device=ctx.device))
        arrays = mx.convert.random_numpy_params(
            mx.convert.param_shapes(net), seed=0 if layers is None else 3)
    mx.convert.load_numpy_params(net, arrays)
    net.cast(dtype)
    net.hybridize()
    return net, arrays


def _zoo_train_v2(torch, mx, state):
    from mxnet_tpu_torch.gluon import fused_step
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    c3 = _c3_check(torch)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()
    net, _ = _v2_net(mx, torch, mx.gpu(0), "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    step = mx.gluon.train_step(net, loss_fn, trainer)
    all_params, train_pos, _ = step._param_split()
    buckets = len(OA.bucketize([all_params[p]._tensor() for p in train_pos]))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_step.reset_stats()
    _zero_counts(BNF, CF, OA)
    losses, modes = [], []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = step(x, y)
        modes.append(step.last_mode)
        losses.append(loss.float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bn = _bn_counts(BNF)
    conv = _conv_counts(CF)
    apply_n = OA.LAUNCHES
    stats = fused_step.stats()
    peak = torch.cuda.max_memory_allocated()
    want = {"stats": 5 * V2_BN, "apply": 5 * V2_BN,
            "bwd_reduce": 5 * V2_BN_BWD, "bwd_dx": 5 * V2_BN_BWD,
            "finalize": 5 * (V2_BN + V2_BN_BWD)}
    ok_counts = all(bn[k] == n for k, n in want.items()) \
        and apply_n == 5 * buckets and conv["fwd"] == 0 \
        and conv["bwd_dx"] == 0 and conv["bwd_dw"] == 0
    ok_mode = all(m == "fused" for m in modes) and stats["fallbacks"] == 0
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state["launches_zoo"] = dict({k: bn[k] for k in BN_KERNELS},
                                 optimizer_apply=apply_n)

    def one_step():
        prev = _set_fused_apply("1")
        try:
            step(x, y)
        finally:
            _set_fused_apply(prev)
    busy_ms, by_kernel, tops = profile_busy_ms(
        torch, one_step, 2, top=8, match=("bn_", "sgd_apply"))
    wall_ms = host_ms(torch, one_step, 3)
    timing = {"images_per_sec": 128 * 1e3 / wall_ms,
              "wall_ms_per_step": wall_ms,
              "images_per_sec_5_steps": 5 * 128 / wall,
              "device_busy_ms_per_step": busy_ms,
              "device_idle_share": None if busy_ms is None
              else max(0.0, 1.0 - busy_ms / wall_ms),
              "kernel_ms_per_step_by_name": by_kernel}
    state["zoo_train_v2"] = dict(timing, peak_bytes=peak, losses=losses)
    emit({"phase": "zoo", "part": "train_resnet50_v2", "layout": "NHWC",
          "dtype": "bfloat16", "batch": 128, "steps": 5, "losses": losses,
          "last_modes": modes, "fused_step_stats": stats,
          "buckets": buckets, "batchnorm_c3": c3,
          "launches": {"batchnorm_fused": bn, "conv_fused": conv,
                       "optimizer_apply": apply_n},
          "launches_wanted": {"batchnorm_fused": want,
                              "optimizer_apply": 5 * buckets,
                              "conv_fused": 0},
          "max_memory_allocated_bytes": peak, "timing": timing,
          "ok": ok_counts and ok_mode and ok_loss})
    if tops:
        emit(dict({"phase": "zoo",
                   "where_the_time_goes": "train_resnet50_v2,b128"}, **tops))
    if not ok_counts:
        raise AssertionError("ResNet-50 V2 launches bn %s, conv %s, apply "
                             "%d; want %s, 0, %d" % (bn, conv, apply_n, want,
                                                     5 * buckets))
    if not ok_mode:
        raise AssertionError("ResNet-50 V2 train_step modes %s, stats %s"
                             % (modes, stats))
    if not ok_loss:
        raise AssertionError("ResNet-50 V2 loss not finite and falling: %s"
                             % losses)
    del net, trainer, step, x
    torch.cuda.empty_cache()
    _v2_narrow_card_vs_cpu(torch, mx)


def _v2_narrow_card_vs_cpu(torch, mx):
    """One f32 fused step (MXTPU_FUSED_APPLY=1) of a narrow ResNet V2 NHWC
    (bottleneck, one unit per stage, widths 16-256, batch 4 of 32x32, the
    stem included), TF32 off, the card against the CPU from the same
    weights: the loss, every parameter and running statistic within
    NARROW_RTOL (tests/test_torch_train.py's bounds)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    x = np.random.RandomState(1).rand(4, 3, 32, 32).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (4,)).astype("float32")
    got, arrays = {}, None
    prev = _set_fused_apply("1")
    try:
        with mx.precision.matmul_precision("float32"):
            for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
                net, arrays = _v2_net(mx, torch, ctx, "float32", NARROW, 32,
                                      arrays)
                step = mx.gluon.train_step(
                    net, SoftmaxCrossEntropyLoss(),
                    mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD)))
                loss = step(torch.from_numpy(x).to(ctx.device),
                            torch.from_numpy(y).to(ctx.device))
                got[where] = (loss.cpu(), {
                    k: p._tensor().detach().cpu()
                    for k, p in net._collect_params_with_prefix().items()},
                    step.last_mode)
    finally:
        _set_fused_apply(prev)
    loss_rel = ((got["card"][0] - got["cpu"][0]).abs().max()
                / got["cpu"][0].abs().max()).item()
    param_rel = max((((got["card"][1][k] - v).abs().max()
                      / v.abs().max().clamp_min(1e-30)).item(), k)
                    for k, v in got["cpu"][1].items())
    ok = loss_rel <= NARROW_RTOL["loss"] \
        and param_rel[0] <= NARROW_RTOL["param"] \
        and got["card"][2] == got["cpu"][2] == "fused"
    emit({"phase": "zoo", "check": "narrow_v2_f32_card_vs_cpu", "batch": 4,
          "steps": 1, "loss_max_rel": loss_rel, "param_max_rel": param_rel,
          "bound_rel": NARROW_RTOL, "ok": ok})
    if not ok:
        raise AssertionError("narrow ResNet V2 f32 step card vs CPU: loss "
                             "%g, param %s" % (loss_rel, param_rel))


def _dropouts(mx, net):
    return [m for m in net.modules() if isinstance(m, mx.gluon.nn.Dropout)]


def _eager_steps(torch, mx, net, x, y, steps):
    """``steps`` eager SGD steps (phase train's): the losses, the wall ms
    per step (the first included) and the step as a function."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = SoftmaxCrossEntropyLoss()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = _train_step(mx, net, trainer, loss_fn, x, y)
        losses.append(loss.detach().float().mean().item())
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / steps * 1e3, \
        lambda: _train_step(mx, net, trainer, loss_fn, x, y)


def _zoo_train_vgg(torch, mx, state):
    rs = np.random.RandomState(1)
    x_np = rs.rand(ZOO_TRAIN_BATCH, 3, 224, 224).astype("float32")
    y_np = rs.randint(0, 1000, (ZOO_TRAIN_BATCH,)).astype("float32")
    net, _ = _zoo_net(mx, torch, "vgg16", mx.gpu(0), 224)
    net.cast("bfloat16")
    drops = _dropouts(mx, net)
    seen = []
    hooks = [d.register_forward_hook(
        lambda m, inp, out, i=i: seen.append((i, inp[0].detach(),
                                              out.detach())))
        for i, d in enumerate(drops)]
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.reset_peak_memory_stats()
    try:
        losses, step_ms, _ = _eager_steps(torch, mx, net, x, y, 3)
        checks = []
        half = torch.tensor(0.5, dtype=torch.bfloat16, device="cuda")
        for i, xin, out in seen:
            live = xin != 0
            kept = (out != 0) & live
            n = int(live.sum().item())
            share = int(kept.sum().item()) / max(n, 1)
            exact = bool(torch.equal(out[kept], (xin / half)[kept])) \
                and not bool((out[~kept] != 0).any().item())
            checks.append({"dropout": i, "nonzero_inputs": n,
                           "keep_share": share,
                           "sigmas": abs(share - 0.5) / np.sqrt(0.25 / n),
                           "kept_exact": exact})
        seen.clear()
        bits = []
        for _ in range(2):
            mx.random.seed(42)
            with mx.autograd.train_mode():
                net(x[:8])
            bits.append([o for _, _, o in seen])
            seen.clear()
        same = len(bits[0]) == len(drops) and all(
            same_bits(torch, a, b) for a, b in zip(*bits))
    finally:
        for h in hooks:
            h.remove()
    ok = all(np.isfinite(losses)) and len(checks) == 3 * len(drops) == 6 \
        and all(c["sigmas"] <= ZOO_DROPOUT_SIGMAS and c["kept_exact"]
                for c in checks) and same
    state["zoo_train_vgg"] = {"wall_ms_per_step": step_ms,
                              "images_per_sec": ZOO_TRAIN_BATCH * 1e3
                              / step_ms}
    emit({"phase": "zoo", "part": "train_vgg16", "layout": "NCHW",
          "dtype": "bfloat16", "batch": ZOO_TRAIN_BATCH, "steps": 3,
          "losses": losses, "dropouts": checks,
          "same_bits_under_one_seed": same,
          "wall_ms_per_step": step_ms,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "ok": ok})
    del net, x, bits
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("VGG-16 training: losses %s, dropouts %s, same "
                             "bits %s" % (losses, checks, same))


def _zoo_train_densenet(torch, mx, state):
    rs = np.random.RandomState(1)
    x_np = rs.rand(ZOO_TRAIN_BATCH, 3, 224, 224).astype("float32")
    y_np = rs.randint(0, 1000, (ZOO_TRAIN_BATCH,)).astype("float32")
    net, _ = _zoo_net(mx, torch, "densenet121", mx.gpu(0), 224)
    net.cast("bfloat16")
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, step = _eager_steps(torch, mx, net, x, y, 3)
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    peak = torch.cuda.max_memory_allocated()
    busy_ms, _, tops = profile_busy_ms(torch, step, 1, top=8, match=())
    state["zoo_train_densenet"] = {"wall_ms_per_step": step_ms,
                                   "images_per_sec": ZOO_TRAIN_BATCH * 1e3
                                   / step_ms}
    emit({"phase": "zoo", "part": "train_densenet121", "layout": "NCHW",
          "dtype": "bfloat16", "batch": ZOO_TRAIN_BATCH, "steps": 3,
          "losses": losses, "wall_ms_per_step": step_ms,
          "device_busy_ms_per_step": busy_ms,
          "max_memory_allocated_bytes": peak, "ok": ok})
    if tops:
        emit(dict({"phase": "zoo",
                   "where_the_time_goes": "train_densenet121,b64"}, **tops))
    del net, x, step
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("DenseNet-121 loss not finite and falling: %s"
                             % losses)


def phase_zoo(torch, state):
    """The vision model zoo on the card: serving every family, ResNet-50
    V2 trained fused (rows 4-8), VGG-16 and DenseNet-121 trained eagerly."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    _zoo_serve(torch, mx, state)
    prev = _set_fused_apply("1")
    try:
        _zoo_train_v2(torch, mx, state)
    finally:
        _set_fused_apply(prev)
    _zoo_train_vgg(torch, mx, state)
    _zoo_train_densenet(torch, mx, state)
    emit({"phase": "zoo", "wall_s": time.perf_counter() - t0, "ok": True})


def _lm_batch(torch, vocab, batch, seq, seed, device):
    """Tokens and targets [batch, seq] from numpy ``seed``, as bench.py
    draws them."""
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randint(0, vocab, (batch, seq)))
                 .to(device) for _ in range(2))


def phase_train_lm(torch, state):
    """The transformer LM's training step at bench_transformer's width:
    5 SGD-momentum steps of make_train_step on one batch, counters zeroed
    just before; then the narrow f32 step, card against CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.parallel import transformer as T

    cfg = T.TransformerConfig(**LM_CFG)
    gpu = mx.gpu(0)
    init_fn, step_fn = T.make_train_step(cfg, learning_rate=LM_LR, ctx=gpu)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = init_fn(0)
    tok, tgt = _lm_batch(torch, cfg.vocab_size, LM_BATCH, LM_SEQ, 0,
                         gpu.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = T.n_params(lm[0])
    for k in FA.LAUNCHES:
        FA.LAUNCHES[k] = 0
    FA.COPIES = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        lm, loss = step_fn(lm, tok, tgt)
        losses.append(float(loss))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(FA.LAUNCHES)
    want = {k: 5 * v for k, v in FLASH_PER_STEP.items()}
    ok_counts = counts == want
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {}).update(
        {"flash_attention." + k: counts[k] for k in counts})
    state["train_lm"] = lambda: step_fn(lm, tok, tgt)
    state["lm_params"] = n
    emit({"phase": "train_lm", "dtype": "bfloat16", "config": LM_CFG,
          "batch": LM_BATCH, "seq": LM_SEQ, "learning_rate": LM_LR,
          "params": n, "steps": 5, "losses": losses, "launches": counts,
          "launches_wanted": want, "do_copies": FA.COPIES,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "init_s": init_s, "wall_s": wall, "ok": ok_counts and ok_loss})
    if not ok_counts:
        raise AssertionError("LM training launches %s, want %s"
                             % (counts, want))
    if not ok_loss:
        raise AssertionError("LM training loss not finite and falling: %s"
                             % losses)
    _lm_f32_card_vs_cpu(torch, mx, T)


def _lm_f32_card_vs_cpu(torch, mx, T, extra=None, phase="train_lm"):
    """One f32 step of the narrow LM (S = 256: the flash branch, or with
    ``extra`` other config fields, such as the blockwise attention mode)
    with TF32 off, on the card against the port on the CPU, from the same
    weights; the CPU in f64 beside both, to tell rounding from a fault."""
    runs = {}
    weights = None
    extra = dict(extra or {})
    with mx.precision.matmul_precision("float32"):
        for name, ctx, dtype in (("cpu", mx.cpu(), "float32"),
                                 ("card", mx.gpu(0), "float32"),
                                 ("cpu_f64", mx.cpu(), "float64")):
            cfg = T.TransformerConfig(**dict(LM_NARROW, dtype=dtype,
                                             **extra))
            init_fn, step_fn = T.make_train_step(cfg, learning_rate=LM_LR,
                                                 ctx=ctx)
            params, mom = init_fn(0)
            if weights is None:
                weights = [p.detach().clone() for p in params.parameters()]
            with torch.no_grad():
                for p, w in zip(params.parameters(), weights):
                    p.copy_(w)
            tok, tgt = _lm_batch(torch, cfg.vocab_size, LM_NARROW_BATCH,
                                 LM_NARROW_SEQ, 2, ctx.device)
            _, loss = step_fn((params, mom), tok, tgt)
            runs[name] = {
                "loss": loss.detach().double().cpu(),
                "grad": {k: m.detach().double().cpu()
                         for k, m in mom.items()},
                "param": {k: p.detach().double().cpu()
                          for k, p in params.named_parameters()}}
    gap = {w: _max_rel(runs["card"], runs["cpu"], w) for w in LM_NARROW_RTOL}
    vs64 = {"%s_vs_cpu_f64_max_rel" % a: {
        w: _max_rel(runs[a], runs["cpu_f64"], w) for w in LM_NARROW_RTOL}
        for a in ("card", "cpu")}
    ok = all(gap[w][0] <= LM_NARROW_RTOL[w] for w in LM_NARROW_RTOL)
    emit(dict({"phase": phase, "dtype": "float32",
               "config": dict(LM_NARROW, **extra), "batch": LM_NARROW_BATCH,
               "seq": LM_NARROW_SEQ, "card_vs_cpu_max_rel": gap}, **vs64,
              bound_rel=LM_NARROW_RTOL, loss=float(runs["card"]["loss"]),
              ok=ok))
    if not ok:
        raise AssertionError("f32 LM step (%s), card vs CPU: %s over %s"
                             % (extra, gap, LM_NARROW_RTOL))


# -- AMP training from a DataLoader (phase train_amp) ------------------------

# bench_resnet's SGD on ResNet-50 v1 NHWC fuse=False with float32
# parameters (numpy seed 0) under amp.init() (bfloat16), fed by a
# DataLoader: AMP_IMAGES synthetic uint8 HWC images with int labels from
# numpy seed AMP_DATA_SEED, RandomFlipLeftRight then Cast("float32"),
# batch 128, shuffle, last_batch "discard", 4 worker threads, pinned.
AMP_IMAGES = 1280
AMP_DATA_SEED = 7
# The labels take 10 of the head's 1000 classes, so that 10 steps on fresh
# batches show the loss falling (the head learns which classes occur):
# over all 1000 classes it falls by less than the noise between batches
# (on an H100, last-3 means 0.08 and 0.01 below the first-3's in two
# runs; PERF.md has them).
AMP_CLASSES = 10
AMP_BATCH = 128
AMP_STEPS = 10
AMP_WORKERS = 4
AMP_SPEEDOMETER = 5
# Ops whose input dtypes the AMP policy decides, and the dtype each must
# get: what the JAX package's cast hook gives them.
AMP_DTYPES = {"Convolution": "bfloat16", "BatchNorm": "float32",
              "FullyConnected": "bfloat16"}
AMP_OPS_PER_STEP = {"Convolution": BN_PER_STEP, "BatchNorm": BN_PER_STEP,
                    "FullyConnected": 1}
# The narrow NHWC ResNet under AMP, one training-mode step (batch 16 of
# 32x32, numpy seeds 11 and 12), card against the port on the CPU: the
# loss within AMP_NARROW_LOSS_RTOL relative, each gradient's gap to the
# CPU's within AMP_NARROW_SPREAD times the gap between the CPU's AMP and
# float32 gradients (AMP's own rounding: tests/test_torch_amp.py's bound).
AMP_NARROW_BATCH = 16
AMP_NARROW_LOSS_RTOL = 5e-3
AMP_NARROW_SPREAD = 3.0

BatchEndParam = collections.namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])


@contextlib.contextmanager
def _op_dtypes(names, record):
    """Record (op name, input dtypes, output dtype) of every call of the
    registry ops ``names`` into ``record``, where the op function receives
    its arguments (after the dispatcher's AMP casts)."""
    from mxnet_tpu_torch.ndarray import register as R
    from mxnet_tpu_torch.ops import registry as REG
    import torch
    saved = {}
    for name in names:
        op = REG.get_op(name)
        R._takes_training(op)           # read the real signature first
        saved[name] = op.fn

        def recording(*a, _fn=op.fn, _name=name, **k):
            out = _fn(*a, **k)
            first = out[0] if isinstance(out, (tuple, list)) else out
            record.append((_name, sorted({
                str(v.dtype).replace("torch.", "")
                for v in list(a) + list(k.values())
                if isinstance(v, torch.Tensor) and v.is_floating_point()}),
                str(first.dtype).replace("torch.", "")))
            return out
        op.fn = recording
    try:
        yield record
    finally:
        for name, fn in saved.items():
            REG.get_op(name).fn = fn


def _amp_loader(mx):
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms as Tr
    rs = np.random.RandomState(AMP_DATA_SEED)
    images = rs.randint(0, 256, (AMP_IMAGES, 224, 224, 3), dtype=np.uint8)
    labels = rs.randint(0, AMP_CLASSES, AMP_IMAGES)
    ds = ArrayDataset(images, labels).transform_first(
        Tr.Compose([Tr.RandomFlipLeftRight(), Tr.Cast("float32")]))
    return DataLoader(ds, batch_size=AMP_BATCH, shuffle=True,
                      last_batch="discard", num_workers=AMP_WORKERS,
                      pin_memory=True)


def _amp_step(mx, amp, net, trainer, loss_fn, x, y):
    """One AMP step as an MXNet script writes it: record, the scaled loss's
    backward, Trainer.step. x: NHWC float32 on the card, made NCHW for the
    net (its layout="NHWC" transposes back inside)."""
    x = x.transpose((0, 3, 1, 2))
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    trainer.step(x.shape[0])
    return out, loss


def phase_train_amp(torch, state):
    """ResNet-50 v1 trained under bf16 AMP from a DataLoader (the module
    docstring, phase 5b)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    try:
        _train_amp(torch, state, mx, amp)
    finally:
        amp._reset()


def _train_amp(torch, state, mx, amp):
    from mxnet_tpu_torch import callback, metric
    from mxnet_tpu_torch.gluon import fused_step
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.utils import split_and_load
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    gpu = mx.gpu(0)
    arrays = _arrays(mx, state)
    net = _build_net(mx, arrays, False, "float32", gpu)
    amp.init()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    loss_fn = SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    speedo = callback.Speedometer(AMP_BATCH, AMP_SPEEDOMETER)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    cb_log = logging.getLogger(callback.__name__)
    cb_log.addHandler(handler)
    cb_log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    loader = _amp_loader(mx)
    data_s = time.perf_counter() - t0
    # the loader alone over one epoch, onto the card (its pinned host
    # buffers allocated afresh: the first epoch's cost)
    t0 = time.perf_counter()
    n_alone = 0
    for data, label in loader:
        n_alone += 1
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0

    # -- the main path: 10 steps, one epoch of the loader ------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF, OA)
    losses, scales, skipped, sync_ok, steps = [], [], 0, True, 0
    ends = []
    t0 = time.perf_counter()
    for i, (data, label) in enumerate(loader):
        x = split_and_load(data, [gpu])[0]
        y = split_and_load(label, [gpu])[0]
        before = scaler.loss_scale
        out, loss = _amp_step(mx, amp, net, trainer, loss_fn, x, y)
        skipped += scaler.loss_scale < before
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc.update([y], [out])
        except RuntimeError as e:
            sync_ok = False
            emit({"phase": "train_amp", "metric_update_synced": str(e)})
        finally:
            torch.cuda.set_sync_debug_mode(0)
        speedo(BatchEndParam(0, i, acc, None))
        losses.append(loss)
        scales.append(scaler.loss_scale)
        steps += 1
        ends.append(time.perf_counter())   # the scaler synced this step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cb_log.removeHandler(handler)
    losses = [float(l.asnumpy().mean()) for l in losses]
    bn, conv, apply_n = _bn_counts(BNF), _conv_counts(CF), OA.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    want = {k: AMP_STEPS * BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * AMP_STEPS * BN_PER_STEP
    ok_counts = steps == AMP_STEPS and all(
        bn[k] == n for k, n in want.items()) and apply_n == 0 \
        and conv["fwd"] == conv["bwd_dx"] == conv["bwd_dw"] == 0
    ok_loss = all(np.isfinite(losses)) and \
        np.mean(losses[-3:]) < np.mean(losses[:3])
    state["launches_amp"] = {k: bn[k] for k in BN_KERNELS}

    # -- the dtypes AMP gave each op, over one more step --------------------
    x0, y0 = x, y
    record = []
    with _op_dtypes(AMP_DTYPES, record):
        _amp_step(mx, amp, net, trainer, loss_fn, x0, y0)
    kinds = {n: sum(r[0] == n for r in record) for n in AMP_DTYPES}
    bad = [r for r in record if r[1] != [AMP_DTYPES[r[0]]]
           or r[2] != AMP_DTYPES[r[0]]]
    ok_dtypes = kinds == AMP_OPS_PER_STEP and not bad

    # -- an inf gradient: the step is skipped, the scale halved -------------
    with mx.autograd.record():
        with amp.scale_loss(loss_fn(net(x0.transpose((0, 3, 1, 2))), y0),
                            trainer) as scaled:
            scaled.backward()
    params = list(net.collect_params().values())
    params[0]._grad_tensor().view(-1)[0] = float("inf")
    weights = [p._tensor().detach().clone() for p in params]
    moms = {i: s.clone() for i, s in trainer._updater.states.items()
            if isinstance(s, torch.Tensor)}
    s0 = scaler.loss_scale
    trainer.step(AMP_BATCH)
    same = all(torch.equal(p._tensor(), w) for p, w in zip(params, weights))
    same_states = all(torch.equal(trainer._updater.states[i], m)
                      for i, m in moms.items())
    ok_skip = same and same_states and scaler.loss_scale == s0 / 2

    # -- the fused step falls back with a scaler attached -------------------
    net.hybridize()
    step = mx.gluon.train_step(net, loss_fn, trainer)
    fused_step.reset_stats()
    step(x0.transpose((0, 3, 1, 2))._data, y0._data)
    ok_fused = step.last_mode == "fallback:amp-loss-scaler" \
        and OA.LAUNCHES == 0

    # -- where the time goes: a step on one resident batch ------------------
    def one_step():
        _amp_step(mx, amp, net, trainer, loss_fn, x0, y0)
    busy_ms, by_kernel, tops = profile_busy_ms(
        torch, one_step, 2, top=8, match=("bn_",))
    wall_ms = host_ms(torch, one_step, 3)
    timing = {"images_per_sec": AMP_BATCH * 1e3 / wall_ms,
              "wall_ms_per_step": wall_ms,
              "wall_ms_per_step_from_loader": wall * 1e3 / max(steps, 1),
              "images_per_sec_from_loader":
                  steps * AMP_BATCH / wall if wall else None,
              "wall_ms_per_step_from_loader_after_the_first":
                  (ends[-1] - ends[0]) * 1e3 / (len(ends) - 1)
                  if len(ends) > 1 else None,
              "loader_alone_ms_per_batch_first_epoch":
                  alone_s * 1e3 / max(n_alone, 1),
              "device_busy_ms_per_step": busy_ms,
              "device_idle_share": None if busy_ms is None
              else max(0.0, 1.0 - busy_ms / wall_ms),
              "device_idle_share_from_loader": None if busy_ms is None
              else max(0.0, 1.0 - busy_ms * steps / (wall * 1e3)),
              "kernel_ms_per_step_by_name": by_kernel}
    state["amp_timing"] = dict(timing, peak_bytes=peak)
    emit({"phase": "train_amp", "card": state["smi"], "layout": "NHWC",
          "params": "float32", "amp": "bfloat16", "batch": AMP_BATCH,
          "steps": steps, "images": AMP_IMAGES, "classes": AMP_CLASSES,
          "workers": AMP_WORKERS,
          "loader_build_s": data_s, "losses": losses,
          "loss_scales": scales, "skipped_steps": int(skipped),
          "accuracy": acc.get_global(), "speedometer": lines,
          "metric_update_no_sync": sync_ok,
          "launches": {"batchnorm_fused": bn, "conv_fused": conv,
                       "optimizer_apply": apply_n},
          "launches_wanted": {"batchnorm_fused": want,
                              "optimizer_apply": 0, "conv_fused": 0},
          "op_dtypes_per_step": kinds, "op_dtypes_wrong": bad[:5],
          "inf_step": {"weights_same_bits": same,
                       "states_same_bits": same_states,
                       "scale_before": s0, "scale_after":
                           scaler.loss_scale},
          "fused_step_mode": step.last_mode,
          "max_memory_allocated_bytes": peak, "timing": timing,
          "ok": ok_counts and ok_loss and sync_ok and ok_dtypes
          and ok_skip and ok_fused and skipped == 0})
    if tops:
        emit(dict({"phase": "train_amp",
                   "where_the_time_goes": "amp_resnet50_v1,b128"}, **tops))
    if not ok_counts:
        raise AssertionError("AMP training launches bn %s, conv %s, apply "
                             "%d over %d steps; want %s, 0, 0"
                             % (bn, conv, apply_n, steps, want))
    if not ok_loss:
        raise AssertionError("AMP training loss not finite and falling: %s"
                             % losses)
    if not sync_ok:
        raise AssertionError("metric.update() synchronized the device")
    if not ok_dtypes:
        raise AssertionError("AMP op dtypes: %s per step, wrong %s"
                             % (kinds, bad[:5]))
    if not ok_skip:
        raise AssertionError("the inf step was not skipped bit for bit "
                             "(weights %s, states %s, scale %s -> %s)"
                             % (same, same_states, s0, scaler.loss_scale))
    if not ok_fused:
        raise AssertionError("the fused step ran %r (packed launches %d)"
                             % (step.last_mode, OA.LAUNCHES))
    if skipped:
        raise AssertionError("%d AMP steps skipped (scales %s)"
                             % (skipped, scales))
    del net, trainer, step, loader, x0, y0, x, y, out, loss, scaled
    torch.cuda.empty_cache()
    _amp_narrow_card_vs_cpu(torch, mx, amp)


def _amp_narrow_run(torch, mx, amp, ctx, arrays, x, y, use_amp):
    """One training-mode step of the narrow NHWC ResNet on ``ctx`` (AMP on
    or off): the loss and every gradient, on the host in float64."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    amp._reset()
    net, _ = _narrow_net(mx, torch, False, ctx, arrays)
    if use_amp:
        amp.init()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    if use_amp:
        amp.init_trainer(trainer)
    xs = mx.nd.array(x, ctx=ctx)
    ys = mx.nd.array(y, ctx=ctx)
    with mx.autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(xs), ys)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    scale = trainer._amp_loss_scaler.loss_scale if use_amp else 1.0
    grads = {k: p._grad_tensor().double().cpu() / scale for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    trainer.step(len(x))
    moved = all(bool(torch.isfinite(p._tensor()).all()) for p in
                net.collect_params().values())
    amp._reset()
    return {"loss": torch.from_numpy(loss.asnumpy()).double(),
            "grad": grads, "finite_after_step": moved}


def _amp_narrow_card_vs_cpu(torch, mx, amp):
    """The narrow NHWC ResNet's AMP step on the card against the port on
    the CPU (AMP_NARROW_*), with the CPU's float32 step as the yardstick
    of AMP's own rounding."""
    rs = np.random.RandomState(11)
    x = rs.rand(AMP_NARROW_BATCH, 3, 32, 32).astype("float32")
    y = np.random.RandomState(12).randint(
        0, 10, (AMP_NARROW_BATCH,)).astype("float32")
    _, arrays = _narrow_net(mx, torch, False, mx.cpu())
    with mx.precision.matmul_precision("float32"):
        card = _amp_narrow_run(torch, mx, amp, mx.gpu(0), arrays, x, y, True)
        cpu = _amp_narrow_run(torch, mx, amp, mx.cpu(), arrays, x, y, True)
        f32 = _amp_narrow_run(torch, mx, amp, mx.cpu(), arrays, x, y, False)
    loss_rel = ((card["loss"] - cpu["loss"]).abs().max()
                / cpu["loss"].abs().max()).item()
    worst = (0.0, None, 0.0, 0.0)
    for k, g in cpu["grad"].items():
        gap = (card["grad"][k] - g).abs().max().item()
        spread = (g - f32["grad"][k]).abs().max().item()
        ratio = gap / max(spread, 1e-30)
        if ratio > worst[0]:
            worst = (ratio, k, gap, spread)
    ok = loss_rel <= AMP_NARROW_LOSS_RTOL and worst[0] <= AMP_NARROW_SPREAD \
        and card["finite_after_step"]
    emit({"phase": "train_amp", "check": "narrow_amp_card_vs_cpu",
          "batch": AMP_NARROW_BATCH, "loss_max_rel": loss_rel,
          "worst_grad_gap_over_amp_spread": {
              "ratio": worst[0], "param": worst[1], "gap": worst[2],
              "cpu_amp_vs_f32": worst[3]},
          "bound": {"loss_rel": AMP_NARROW_LOSS_RTOL,
                    "grad_gap_over_spread": AMP_NARROW_SPREAD}, "ok": ok})
    if not ok:
        raise AssertionError("narrow AMP step card vs CPU: loss %g, worst "
                             "gradient %s" % (loss_rel, worst))


# -- the deep transformer LM (phase train_lm_deep) ---------------------------

# bench.py's deep config (bench.py:75-90,179-190): 24 layers of dim 2048,
# 16 heads of 128, FFN 8192, vocab 32000, bf16, chunked CE over 8 chunks,
# full per-layer recompute; batch 8 x 2048 (1.74B parameters).
# -- phase train_rec: bench_input_pipeline's path on the port -----------------
REC_IMAGES = 2048               # _synth_rec(raw=True): 2048 records of
REC_SIDE = 256                  # 256 x 256 x 3 uint8 (~403 MB)
REC_CLASSES = 10                # labels i % 10, as AMP_CLASSES
REC_BATCH = 128
REC_EPOCHS = 2
REC_STEPS = REC_IMAGES // REC_BATCH          # 16 per epoch
REC_SHAPE = (3, 224, 224)
# bench.py's on-card normalisation of the uint8 feed
REC_MEAN = (123.68, 116.78, 103.94)
REC_SCALE = 1.0 / 58.0
# the reference's ImageNet recipe
REC_XAVIER = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
# SGD with momentum 0.9 as in phase train_sharded, at a tenth of its
# learning rate: from this initialisation (every BatchNorm gamma 1) the
# pooled features of these noise images share one mean of squared norm
# ~1.8e9, and at lr 0.01 the loss falls to ~3.3 by step 4 and then climbs
# past 20 -- in float32 without any kernel of the repository too
# (chip_rec_probe.py); at 1e-3 it falls to ~2.4 (ln 10: the labels'
# prior) by epoch 2
REC_SGD = {"learning_rate": 0.001, "momentum": 0.9}
# the epoch-2 mean loss must lie this many nats below epoch 1's
REC_LOSS_DROP = 1.0
# epoch-2 steps run (and timed) before 2 steps under the profiler
REC_TIMED_STEPS = 8
# every REC_STRIDE-th pixel row and column of each image, summed: the
# per-batch fingerprint the card's batches are held to the host's by
REC_STRIDE = 7
# train_jpeg's records: bench.py's _synth_rec encodes at quality 90
JPEG_QUALITY = 90


def _write_rec(mx, folder, jpeg=False):
    """The .rec/.idx of REC_IMAGES images from numpy seed 0: raw pixels,
    or JPEG at quality JPEG_QUALITY (bench.py's _synth_rec)."""
    from mxnet_tpu_torch import recordio
    rec = os.path.join(folder, "train.rec")
    idx = os.path.join(folder, "train.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(REC_IMAGES):
        img = rng.randint(0, 255, (REC_SIDE, REC_SIDE, 3), np.uint8)
        header = recordio.IRHeader(0, float(i % REC_CLASSES), i, 0)
        w.write_idx(i, recordio.pack_img(header, img, quality=JPEG_QUALITY,
                                         img_fmt=".jpg") if jpeg
                    else recordio.pack_raw_img(header, img))
    w.close()
    return rec, idx


def _rec_iter(mx, rec, idx):
    return mx.io.ImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=REC_SHAPE,
        batch_size=REC_BATCH, shuffle=True, rand_crop=True,
        rand_mirror=True, dtype="uint8",
        preprocess_threads=min(8, os.cpu_count() or 1))


def _fingerprint(x, label):
    """(strided pixel sum per image, label) of a batch, numpy or torch."""
    sub = x[:, :, ::REC_STRIDE, ::REC_STRIDE]
    if isinstance(sub, np.ndarray):
        return sub.sum(axis=(1, 2, 3), dtype=np.int64), label
    import torch
    return sub.sum(dim=(1, 2, 3), dtype=torch.int64), label


def _host_pass(mx, rec, idx):
    """The iterator alone on the host over two epochs, as the fed run will
    see them: its sustained images/sec, each batch's fingerprint, each
    epoch's order and the first two batches in full."""
    t0 = time.perf_counter()
    it = _rec_iter(mx, rec, idx)
    prints, orders, first, n = [], [], [], 0
    for epoch in range(REC_EPOCHS):
        if epoch:
            it.reset()
        orders.append(list(it._order))
        for b in it:
            x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
            if len(first) < 2:
                first.append((x, y))
            prints.append(_fingerprint(x, y) + (b.pad,))
            n += x.shape[0]
    wall = time.perf_counter() - t0
    return n / wall, prints, orders, first


def _h2d_mbps(torch):
    """Host-to-card MB/s of one uint8 batch from pinned memory, best of 5."""
    src = torch.empty((REC_BATCH,) + REC_SHAPE, dtype=torch.uint8,
                      pin_memory=True)
    dst = torch.empty(src.shape, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return src.numel() / best / 1e6


def phase_train_rec(torch, state, jpeg=False):
    """Path train_rec: ResNet-50 v1 NHWC bf16, Xavier-initialised, trained
    by parallel.ShardedTrainStep (the `sharded` configuration) from a
    raw-pixel .rec file (``jpeg``: a JPEG one) through ImageRecordIter and
    DevicePrefetchIter."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    folder = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        _train_rec(torch, state, mx, folder, jpeg)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def phase_train_jpeg(torch, state):
    """Path train_jpeg: train_rec's on JPEG records decoded by cv2."""
    from mxnet_tpu_torch.base import cv2
    emit({"phase": "train_jpeg", "cv2": cv2().__version__,
          "cv2_threads": cv2().getNumThreads(), "cpus": os.cpu_count()})
    phase_train_rec(torch, state, jpeg=True)


def _train_rec(torch, state, mx, folder, jpeg=False):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    phase = "train_jpeg" if jpeg else "train_rec"
    key = "jpeg" if jpeg else "rec"
    t0 = time.perf_counter()
    rec, idx = _write_rec(mx, folder, jpeg)
    write_s = time.perf_counter() - t0
    rec_bytes = os.path.getsize(rec)
    img_s, host_prints, host_orders, host_first = _host_pass(mx, rec, idx)
    h2d = _h2d_mbps(torch)

    gpu = mx.gpu(0)
    dev = gpu.device
    mx.random.seed(0)
    net = resnet50_v1(layout="NHWC", fuse=True)
    net.initialize(mx.init.Xavier(**REC_XAVIER), ctx=gpu)
    net(torch.zeros((1,) + REC_SHAPE, device=dev))
    net.cast("bfloat16")
    links = sum(1 for m in net.modules() if getattr(m, "_fuse", False))
    fed = _sharded_step(mx, torch, net, ("sgd", REC_SGD), dev)
    resident = _sharded_step(mx, torch, net, ("sgd", REC_SGD), dev)
    mean = torch.tensor(REC_MEAN, dtype=torch.bfloat16,
                        device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(REC_SCALE, dtype=torch.bfloat16, device=dev)

    def normalize(u8):
        # bench.py's (u8 - mean) * scale in bf16, NCHW; the net's first op
        # is its boundary transpose to NHWC
        return (u8.to(torch.bfloat16) - mean) * scale

    it = _rec_iter(mx, rec, idx)
    orders = [list(it._order)]
    pf = mx.io.DevicePrefetchIter(it, depth=2, sharding=gpu)
    b0 = next(pf)

    # the resident step on the host iterator's first batch, before the
    # counted run: its loss is the fed step's, bit for bit
    x_host, y_host = host_first[0]
    xr, yr = resident.place_batch(x_host, y_host)
    prev = _deterministic_cudnn(torch)
    try:
        loss_resident = resident.step(normalize(xr), yr)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev

    # -- the main path: 2 epochs of 16 fed steps ----------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF)
    losses, prints, kept, pads = [], [], [], []
    epoch_s = []

    def fed_step(batch):
        x, y = batch.data[0]._data, batch.label[0]._data
        prints.append(_fingerprint(x, y))
        pads.append(batch.pad)
        if len(kept) < 2:
            kept.append((x, y))
        losses.append(fed.step(normalize(x), y))

    prev = _deterministic_cudnn(torch)
    try:
        t0 = time.perf_counter()
        fed_step(b0)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    for b in pf:
        fed_step(b)
    torch.cuda.synchronize()
    epoch_s.append(time.perf_counter() - t0)
    n_epoch1 = len(losses)
    pf.reset()
    orders.append(list(it._order))
    t0 = time.perf_counter()
    for _ in range(REC_TIMED_STEPS):
        fed_step(next(pf))
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - t0) * 1e3 / REC_TIMED_STEPS
    busy_fed, by_kernel, tops = profile_busy_ms(
        torch, lambda: fed_step(next(pf)), 2, top=8,
        match=("bn_", "conv_fused_", "Memcpy"))
    for b in pf:
        fed_step(b)
    torch.cuda.synchronize()
    epoch_s.append(time.perf_counter() - t0)
    conv, bn = _conv_counts(CF), _bn_counts(BNF)
    peak = torch.cuda.max_memory_allocated()
    steps = len(losses)

    # -- the checks ---------------------------------------------------------
    losses = [float(v) for v in losses]
    want_conv, want_bn = _sharded_want(links, None)
    ok_counts = links == FUSED_PER_STEP and steps == REC_EPOCHS * REC_STEPS \
        and all(conv[k] == steps * n for k, n in want_conv.items()) \
        and all(bn[k] == steps * n for k, n in want_bn.items())
    keys = list(range(REC_IMAGES))
    ok_order = n_epoch1 == REC_STEPS and all(
        sorted(o) == keys for o in orders + host_orders) \
        and orders == host_orders and orders[0] != orders[1] \
        and not any(pads) and len(prints) == len(host_prints) and all(
            np.array_equal(p[0].cpu().numpy(), h[0])
            and np.array_equal(p[1].cpu().numpy(), h[1]) and h[2] == 0
            for p, h in zip(prints, host_prints))
    ok_bytes = all(
        np.array_equal(x.cpu().numpy(), hx) and np.array_equal(
            y.cpu().numpy(), hy)
        for (x, y), (hx, hy) in zip(kept, host_first)) and len(kept) == 2
    loss_fed0 = losses[0]
    ok_first = loss_fed0 == float(loss_resident)
    m1 = float(np.mean(losses[:REC_STEPS]))
    m2 = float(np.mean(losses[REC_STEPS:]))
    ok_loss = all(np.isfinite(losses)) and m2 < m1 - REC_LOSS_DROP

    # -- where the time goes: the resident step -----------------------------
    xn = normalize(xr)

    def resident_step():
        resident.step(xn, yr)
    resident_ms = host_ms(torch, resident_step, 5)
    busy_res, _, _ = profile_busy_ms(torch, resident_step, 2)
    timing = {
        "iterator_images_per_sec": img_s,
        "host_to_card_MBps_pinned": h2d,
        "fed_wall_ms_per_step": fed_ms,
        "resident_wall_ms_per_step": resident_ms,
        "fed_images_per_sec": REC_BATCH * 1e3 / fed_ms,
        "resident_images_per_sec": REC_BATCH * 1e3 / resident_ms,
        "epoch_wall_s": epoch_s,
        "device_busy_ms_per_fed_step": busy_fed,
        "device_busy_ms_per_resident_step": busy_res,
        "device_idle_share_fed": None if busy_fed is None
        else max(0.0, 1.0 - busy_fed / fed_ms),
        "device_idle_share_resident": None if busy_res is None
        else max(0.0, 1.0 - busy_res / resident_ms),
        "kernel_ms_per_fed_step_by_name": by_kernel,
        "peak_gb": peak / 1e9}
    state["launches_" + key] = {
        "conv_fused": conv["fwd"], "conv_fused.bwd_dx": conv["bwd_dx"],
        "conv_fused.bwd_dw": conv["bwd_dw"],
        **{k: bn[k] for k in BN_KERNELS}}
    if jpeg:
        raw = state.get("rec_timing")
        timing["raw_iterator_images_per_sec_same_run"] = \
            None if raw is None else raw["iterator_images_per_sec"]
    state[key + "_timing"] = timing
    emit({"phase": phase, "card": state["smi"], "records": REC_IMAGES,
          "format": "jpeg q%d" % JPEG_QUALITY if jpeg else "raw",
          "record_side": REC_SIDE, "rec_bytes": rec_bytes,
          "write_s": write_s, "batch": REC_BATCH, "epochs": REC_EPOCHS,
          "steps": steps, "init": "Xavier(%s)" % REC_XAVIER,
          "sgd": REC_SGD,
          "losses": losses, "loss_mean_epoch": [m1, m2],
          "first_step_loss": {"fed": loss_fed0,
                              "resident": float(loss_resident)},
          "launches": {"conv_fused": conv, "batchnorm_fused": bn},
          "launches_wanted_per_step": {"conv_fused": want_conv,
                                       "batchnorm_fused": want_bn},
          "order_every_record_once": ok_order,
          "first_two_batches_bytes_equal": ok_bytes,
          "timing": timing,
          "ok": ok_counts and ok_order and ok_bytes and ok_first and ok_loss})
    if tops:
        emit(dict({"phase": phase,
                   "where_the_time_goes": "%s_fed_resnet50_v1,b128" % key},
                  **tops))
    if not ok_counts:
        raise AssertionError(
            "%s launches conv %s, bn %s over %d steps (%d fused "
            "links); want per step %s, %s" % (phase, conv, bn, steps, links,
                                              want_conv, want_bn))
    if not ok_order:
        raise AssertionError("%s: an epoch did not yield every record "
                             "once in the host iterator's order" % phase)
    if not ok_bytes:
        raise AssertionError("%s: the first two batches on the card "
                             "differ from the host iterator's" % phase)
    if not ok_first:
        raise AssertionError("%s: the first fed step's loss %r is "
                             "not the resident step's %r"
                             % (phase, loss_fed0, float(loss_resident)))
    if not ok_loss:
        raise AssertionError("%s: loss not finite or epoch 2's mean "
                             "%.4f not %.1f below epoch 1's %.4f"
                             % (phase, m2, REC_LOSS_DROP, m1))
    del net, fed, resident, pf, it, kept, xn, xr, b0
    torch.cuda.empty_cache()


# -- phase train_det: example/ssd/train_ssd.py on the card --------------------
# The example's recipe (make_rec_dataset, make_det_iter, TinySSD, _ssd_loss,
# train_from_rec, detect, make_batch), written here on the port's API: this
# script imports nothing of example/, which imports the JAX package.
SSD_SIZES = (0.3, 0.45)
SSD_RATIOS = (1.0, 2.0, 0.5)
SSD_EPOCHS = 12
SSD_SGD = {"learning_rate": 0.1, "momentum": 0.9}
SSD_LOSS_RATIO = 0.7            # the example's check: last < 0.7 x first
DET_RTOL = 1e-5                 # detect, card against CPU
# SSD300 on VOC: feature maps, anchors per location and their sizes
SSD300_MAPS = ((38, 4), (19, 6), (10, 6), (5, 6), (3, 4), (1, 4))
SSD300_SCALES = (0.1, 0.2, 0.37, 0.54, 0.71, 0.88, 1.05)
SSD300_ANCHORS = sum(m * m * a for m, a in SSD300_MAPS)         # 8732
SSD300_CLASSES = 21
SSD300_BATCH = 32
SSD300_GT = 16
SSD300_NMS = 0.45
# MultiBoxTarget's and MultiBoxDetection's coordinates, card against CPU
# (exp and log differ by an ulp between the two)
SSD300_RTOL = 1e-5
# the least fp32 work of one IoU test with both areas known: 4 min/max,
# 2 differences, 2 clamps, 1 product (the intersection), 2 for the union,
# 1 quotient and 1 comparison
NMS_IOU_OPS = 13


def ssd_make_batch(rng, batch=8, size=32):
    """Images with one white square and label rows (cls, x1, y1, x2, y2)
    in [0, 1], padded with -1 rows (the example's make_batch)."""
    x = rng.rand(batch, 3, size, size).astype("float32") * 0.1
    labels = np.full((batch, 2, 5), -1.0, "float32")
    for i in range(batch):
        w = rng.randint(8, 16)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - w)
        x[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return x, labels


def ssd_make_rec_dataset(mx, path, n=64, size=64, seed=0):
    """The synthetic-squares dataset as a JPEG .rec with the reference's
    detection labels ([header width, object width, cls, x1, y1, x2, y2])
    (the example's make_rec_dataset)."""
    rng = np.random.RandomState(seed)
    idx = path.replace(".rec", ".idx")
    w = mx.recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 25).astype(np.uint8)
        sq = rng.randint(size // 4, size // 2)
        x0 = rng.randint(0, size - sq)
        y0 = rng.randint(0, size - sq)
        img[y0:y0 + sq, x0:x0 + sq] = 255
        label = [2.0, 5.0, 0.0, x0 / size, y0 / size,
                 (x0 + sq) / size, (y0 + sq) / size]
        header = mx.recordio.IRHeader(0, label, i, 0)
        w.write_idx(i, mx.recordio.pack_img(header, img, quality=95))
    w.close()
    return path, idx


def ssd_det_iter(mx, path_imgrec, path_imgidx, batch_size=8, data_size=32):
    """Random constrained crop, random expansion pad and flip, all
    label-aware (the example's make_det_iter)."""
    return mx.image.ImageDetIter(
        batch_size=batch_size, data_shape=(3, data_size, data_size),
        path_imgrec=path_imgrec, path_imgidx=path_imgidx, shuffle=True,
        rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
        min_object_covered=0.5, std=np.array([255.0, 255.0, 255.0]))


def ssd_tiny(mx, num_classes=1, num_anchors=4):
    """The example's TinySSD: two conv-relu-pool stages and per-location
    class and box heads."""
    gluon = mx.gluon

    class TinySSD(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.backbone = gluon.nn.HybridSequential()
            for ch in (16, 32):
                self.backbone.add(gluon.nn.Conv2D(ch, 3, padding=1),
                                  gluon.nn.Activation("relu"),
                                  gluon.nn.MaxPool2D(2))
            self.cls_head = gluon.nn.Conv2D(
                num_anchors * (num_classes + 1), 3, padding=1)
            self.box_head = gluon.nn.Conv2D(num_anchors * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            return feat, self.cls_head(feat), self.box_head(feat)
    return TinySSD()


def ssd_loss(mx, net, x, labels, sizes=SSD_SIZES, ratios=SSD_RATIOS):
    """Softmax CE over the matched and mined anchors plus smooth-L1 over
    the positive boxes (the example's _ssd_loss)."""
    nd = mx.nd
    feat, cls, box = net(x)
    B = x.shape[0]
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=sizes, ratios=ratios)
    anchors = anchors.reshape(1, -1, 4)
    A = anchors.shape[1]
    cls_pred = nd.transpose(cls, axes=(0, 2, 3, 1)).reshape(B, A, 2)
    cls_pred_t = nd.transpose(cls_pred, axes=(0, 2, 1))
    box_flat = nd.transpose(box, axes=(0, 2, 3, 1)).reshape(B, -1)
    loc_target, loc_mask, cls_target = nd.contrib.MultiBoxTarget(
        anchors, labels, cls_pred_t, overlap_threshold=0.5,
        negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    flat_pred = cls_pred.reshape(-1, 2)
    flat_tgt = cls_target.reshape(-1)
    keep = flat_tgt >= 0
    safe_tgt = nd.where(keep, flat_tgt, nd.zeros_like(flat_tgt))
    logp = nd.log_softmax(flat_pred, axis=-1)
    ce = -nd.pick(logp, safe_tgt, axis=-1) * keep
    n_kept = nd.maximum(keep.sum(), nd.ones((1,), ctx=x.context))
    cls_loss = ce.sum() / n_kept
    n_pos = nd.maximum(loc_mask.sum() / 4.0, nd.ones((1,), ctx=x.context))
    box_loss = (nd.smooth_l1((box_flat - loc_target) * loc_mask,
                             scalar=1.0)).sum() / n_pos
    return cls_loss + box_loss


def ssd_detect(mx, net, x, sizes=SSD_SIZES, ratios=SSD_RATIOS):
    """MultiBoxDetection's decode and NMS (the example's detect)."""
    nd = mx.nd
    feat, cls, box = net(x)
    B = x.shape[0]
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=sizes, ratios=ratios)
    anchors = anchors.reshape(1, -1, 4)
    A = anchors.shape[1]
    cls_pred = nd.transpose(cls, axes=(0, 2, 3, 1)).reshape(B, A, 2)
    cls_prob = nd.softmax(nd.transpose(cls_pred, axes=(0, 2, 1)), axis=1)
    box_flat = nd.transpose(box, axes=(0, 2, 3, 1)).reshape(B, -1)
    return nd.contrib.MultiBoxDetection(cls_prob, box_flat, anchors,
                                        nms_threshold=0.45)


def ssd_train_from_rec(mx, rec_dir, ctx, epochs=SSD_EPOCHS, log=None):
    """TinySSD trained from the JPEG .rec through ImageDetIter (the
    example's train_from_rec); the batches go to ``ctx``. Returns (net,
    per-epoch mean losses)."""
    rec, idx = ssd_make_rec_dataset(mx, os.path.join(rec_dir,
                                                     "ssd_synth.rec"))
    it = ssd_det_iter(mx, rec, idx)
    net = ssd_tiny(mx)
    net.initialize(ctx=ctx)
    first = next(iter(it))
    net(first.data[0].as_in_context(ctx))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SSD_SGD))
    epoch_losses = []
    for ep in range(epochs):
        it.reset()
        total, nb = 0.0, 0
        for batch in it:
            x = batch.data[0].as_in_context(ctx)
            labels = batch.label[0].as_in_context(ctx)
            with mx.autograd.record():
                loss = ssd_loss(mx, net, x, labels)
            loss.backward()
            trainer.step(x.shape[0])
            total += float(loss.asnumpy().reshape(-1)[0])
            nb += 1
        epoch_losses.append(total / nb)
        if log is not None:
            log(ep, epoch_losses[-1])
    return net, epoch_losses


def _ssd300_inputs(torch):
    """SSD300-on-VOC inputs from numpy seed 3: the six feature maps, the
    labels (up to SSD300_GT rows each, -1 rows after), class scores and
    box offsets for every anchor."""
    rs = np.random.RandomState(3)
    feats = [np.zeros((1, 1, m, m), np.float32) for m, _ in SSD300_MAPS]
    labels = np.full((SSD300_BATCH, SSD300_GT, 5), -1.0, np.float32)
    for i in range(SSD300_BATCH):
        k = rs.randint(1, SSD300_GT + 1)
        xy = rs.uniform(0.0, 0.7, (k, 2))
        wh = rs.uniform(0.05, 0.3, (k, 2))
        labels[i, :k, 0] = rs.randint(0, SSD300_CLASSES - 1, k)
        labels[i, :k, 1:3] = xy
        labels[i, :k, 3:5] = xy + wh
    cls = rs.randn(SSD300_BATCH, SSD300_CLASSES,
                   SSD300_ANCHORS).astype(np.float32)
    loc = (rs.randn(SSD300_BATCH, SSD300_ANCHORS * 4) * 0.5).astype(
        np.float32)
    prob = torch.softmax(torch.from_numpy(cls), dim=1).numpy()
    return feats, labels, cls, prob, loc


def _ssd300_priors(torch, mx, feats):
    """The 8,732 SSD300 anchors, [1, A, 4], from MultiBoxPrior per map
    (``feats``: the six maps, as tensors on the device to run on)."""
    C = mx.nd.contrib
    out = []
    for k, ((m, a), f) in enumerate(zip(SSD300_MAPS, feats)):
        s, s2 = SSD300_SCALES[k], SSD300_SCALES[k + 1]
        ratios = (1.0, 2.0, 0.5) if a == 4 else (1.0, 2.0, 0.5, 3.0,
                                                  1.0 / 3.0)
        out.append(C.MultiBoxPrior(f, sizes=(s, (s * s2) ** 0.5),
                                   ratios=ratios))
    return torch.cat(out, 1)


def _no_sync(torch, fn):
    """fn() with any host synchronisation raising, then the result."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _ssd300_ops(torch, mx, state, card="cuda"):
    """MultiBoxPrior, MultiBoxTarget and MultiBoxDetection at SSD300 scale,
    card against CPU, with no host synchronisation; their device ms; the
    box_nms kernel against its plain version, and timed."""
    from mxnet_tpu_torch.kernels import box_nms as NMS
    C = mx.nd.contrib
    feats, labels, cls, prob, loc = _ssd300_inputs(torch)
    res, times = {}, {}
    runs = {}
    # box_nms launches of the three ops' one run each (not of the timing)
    path_launches = 0
    for where in (card, "cpu"):
        d = torch.device(where)
        fs = [torch.from_numpy(f).to(d) for f in feats]
        lab = torch.from_numpy(labels).to(d)
        c = torch.from_numpy(cls).to(d)
        p = torch.from_numpy(prob).to(d)
        lo = torch.from_numpy(loc).to(d)
        fns = {"MultiBoxPrior": lambda: _ssd300_priors(torch, mx, fs)}
        anchors = fns["MultiBoxPrior"]()
        fns["MultiBoxTarget"] = lambda: C.MultiBoxTarget(
            anchors, lab, c, overlap_threshold=0.5,
            negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        fns["MultiBoxDetection"] = lambda: C.MultiBoxDetection(
            p, lo, anchors, nms_threshold=SSD300_NMS)
        out = {}
        for name, fn in fns.items():
            if where == card:
                before = NMS.LAUNCHES
                out[name] = _no_sync(torch, fn)
                path_launches += NMS.LAUNCHES - before
                times[name] = {"device_ms": device_ms(torch, fn, 5),
                               "device_busy_ms": device_busy_ms(torch, fn,
                                                                5),
                               "wall_ms": host_ms(torch, fn, 5)}
            else:
                out[name] = fn()
        runs[where] = out
        if where == card:
            card_inputs = (fs, p, lo)
    ok = True
    for name in runs["cpu"]:
        g = runs[card][name]
        w = runs["cpu"][name]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        errs = []
        for gi, wi in zip(g, w):
            gi, wi = gi.cpu().float(), wi.float()
            scale = max(float(wi.abs().max()), 1e-30)
            errs.append(float((gi - wi).abs().max()) / scale)
        if name == "MultiBoxTarget":
            # the mask and class targets exactly, the offsets within rtol
            exact = torch.equal(g[1].cpu(), w[1]) and torch.equal(
                g[2].cpu(), w[2])
            ok_op = exact and errs[0] <= SSD300_RTOL
        elif name == "MultiBoxDetection":
            gd, wd = g[0].cpu(), w[0]
            exact = torch.equal(gd[..., :2], wd[..., :2])
            ok_op = exact and errs[0] <= SSD300_RTOL
        else:
            ok_op = errs[0] <= 1e-6
        res[name] = dict({"rel_err": errs, "ok": bool(ok_op),
                          "host_syncs": 0}, **times[name])
        ok = ok and ok_op
    kept = int((runs["cpu"]["MultiBoxDetection"][..., 0] >= 0).sum())

    # the box_nms kernel alone at this scale, on the sorted inputs that
    # MultiBoxDetection gave it on the card
    seen = []
    keep_fn = NMS.keep

    def record(*a, **k):
        seen.append((a, k))
        return keep_fn(*a, **k)
    before = NMS.LAUNCHES
    NMS.keep = record
    try:
        fs, p, lo = card_inputs
        C.MultiBoxDetection(p, lo, _ssd300_priors(torch, mx, fs),
                            nms_threshold=SSD300_NMS)
    finally:
        NMS.keep = keep_fn
    (boxes, ids, nvalid, thr), kw = seen[0]
    got = NMS.keep(boxes, ids, nvalid, thr, **kw)
    want = NMS.keep_reference(boxes, ids, nvalid, thr, **kw)
    ok_nms = torch.equal(got.cpu(), want)
    ms = device_ms(torch, lambda: NMS.keep(boxes, ids, nvalid, thr, **kw),
                   5)
    split = kernel_ms(torch, lambda: NMS.keep(boxes, ids, nvalid, thr,
                                              **kw), 5,
                      {"mask": ("nms_mask",), "walk": ("nms_walk",)})
    wall = host_ms(torch, lambda: NMS.keep(boxes, ids, nvalid, thr, **kw), 5)
    t0 = time.perf_counter()
    NMS.keep_reference(boxes, ids, nvalid, thr, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    NMS.LAUNCHES = before
    # the pairs this run's data needs an IoU for: those of one class
    # within an image's valid prefix
    pairs = 0.0
    for b, nv in enumerate(nvalid.cpu().tolist()):
        k = torch.bincount(ids[b, :nv].long().cpu()).double()
        pairs += float((k * (k - 1) / 2).sum())
    # bytes: boxes and ids read once, keep written once; operations:
    # NMS_IOU_OPS fp32 operations per pair, on the CUDA cores
    nbytes = boxes.numel() * 4 + ids.numel() * 4 + got.numel()
    card = state["card"][1]
    t_bytes = nbytes / card[2] * 1e3
    t_ops = pairs * NMS_IOU_OPS / card[1] * 1e3
    state["nms_timing"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "pairs": pairs, "kernel_ms_by_name": split, "wall_ms": wall,
        "plain_note": "keep_reference on the host, its inputs copied "
        "there (wall ms)"}
    res["box_nms_kernel"] = {"equal_to_plain": bool(ok_nms),
                             **state["nms_timing"]}
    return ok and ok_nms, res, kept, path_launches


def _det_op_cases(rs):
    """(op name, numpy inputs, kwargs, tolerance) for every new op that
    train_det's path does not run, at the sizes of their CPU tests."""
    def U(*s):
        return rs.uniform(-1, 1, s).astype(np.float32)

    def boxes(n, scale=1.0):
        b = rs.uniform(0, 0.6, (n, 4)).astype(np.float32)
        b[:, 2:] = b[:, :2] + rs.uniform(0.05, 0.4, (n, 2))
        return b * scale
    rec = np.concatenate([rs.randint(0, 3, (2, 60, 1)).astype(np.float32),
                          rs.uniform(0, 1, (2, 60, 1)).astype(np.float32),
                          np.stack([boxes(60), boxes(60)])], -1)
    rois = np.concatenate([np.array([[0], [1], [0]], np.float32),
                           boxes(3, 14.0)], 1)
    rrois = np.array([[0, 6, 7, 5, 3, 30], [1, 8, 5, 4, 6, -45]],
                     np.float32)
    img = rs.randint(0, 256, (6, 7, 3)).astype(np.float32)
    A = 3
    cls_prob = rs.uniform(0, 1, (2, 2 * A, 5, 6)).astype(np.float32)
    im_info = np.array([[80, 96, 1.0], [64, 90, 1.0]], np.float32)
    prop = dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=20, threshold=0.7,
                rpn_min_size=4, scales=(2, 4, 8), ratios=(1.0,),
                feature_stride=16)
    return [
        ("box_iou", (boxes(5), boxes(7)), {}, 1e-6),
        ("box_nms", (rec,), dict(overlap_thresh=0.3, id_index=0,
                                 topk=40), 1e-6),
        ("bipartite_matching", (rs.uniform(0, 1, (2, 6, 9)).astype(
            np.float32),), dict(threshold=0.1), 0.0),
        ("ROIAlign", (U(2, 3, 16, 16), rois), dict(pooled_size=(3, 3),
                                                   sample_ratio=2), 1e-5),
        ("ROIPooling", (U(2, 3, 16, 16), rois), dict(pooled_size=(3, 3)),
         1e-6),
        ("PSROIPooling", (U(2, 2 * 9, 16, 16), rois),
         dict(output_dim=2, pooled_size=3, group_size=3), 1e-5),
        ("DeformablePSROIPooling", (U(2, 2 * 9, 16, 16), rois,
                                    U(3, 2, 3, 3) * 0.2),
         dict(output_dim=2, group_size=3, pooled_size=3, part_size=3,
              sample_per_part=2, trans_std=0.1), 1e-5),
        ("DeformableConvolution", (U(2, 4, 9, 9), U(2, 18, 9, 9),
                                   U(6, 4, 3, 3), U(6)),
         dict(kernel=(3, 3), pad=(1, 1), num_filter=6), 1e-5),
        ("RROIAlign", (U(2, 3, 12, 12), rrois),
         dict(pooled_size=(2, 3), sampling_ratio=2), 1e-5),
        ("SpatialTransformer", (U(2, 3, 8, 9), np.array(
            [[0.9, 0.1, 0.05, -0.1, 0.8, 0.0]] * 2, np.float32)),
         dict(target_shape=(6, 7)), 1e-5),
        ("BilinearResize2D", (U(2, 3, 8, 9),), dict(height=5, width=13),
         1e-5),
        ("AdaptiveAvgPooling2D", (U(2, 3, 8, 9),), dict(output_size=(3, 4)),
         1e-5),
        ("Correlation", (U(2, 3, 9, 9), U(2, 3, 9, 9)),
         dict(kernel_size=3, max_displacement=2, pad_size=2), 1e-5),
        ("Crop", (U(2, 3, 8, 9),), dict(h_w=(5, 6), center_crop=True), 0.0),
        ("_contrib_Proposal", (cls_prob[:1], U(1, 4 * A, 5, 6) * 0.1,
                               im_info[:1]), prop, 1e-6),
        ("_contrib_MultiProposal", (cls_prob, U(2, 4 * A, 5, 6) * 0.1,
                                    im_info), prop, 1e-6),
        ("_image_to_tensor", (img.astype(np.uint8),), {}, 1e-6),
        ("_image_normalize", (np.transpose(img, (2, 0, 1)) / 255.0,),
         dict(mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.25)), 1e-6),
        ("_image_flip_left_right", (img,), {}, 0.0),
        ("_image_flip_top_bottom", (img,), {}, 0.0),
        ("_image_resize", (img,), dict(size=(9, 4)), 1e-5),
        ("_image_crop", (img,), dict(x=1, y=2, width=4, height=3), 0.0),
        ("_image_random_brightness", (img,), dict(min_factor=0.7,
                                                  max_factor=0.7), 1e-6),
        ("_image_random_contrast", (img,), dict(min_factor=0.6,
                                                max_factor=0.6), 1e-6),
        ("_image_random_saturation", (img,), dict(min_factor=1.3,
                                                  max_factor=1.3), 1e-6),
        ("_image_random_hue", (img,), dict(min_factor=0.1,
                                           max_factor=0.1), 1e-5),
        ("_image_random_color_jitter", (img,), dict(brightness=0.0,
                                                    contrast=0.0), 1e-6),
        ("_image_random_flip_left_right", (img,), dict(p=1.0), 0.0),
        ("_image_random_flip_top_bottom", (img,), dict(p=0.0), 0.0),
        ("_image_random_lighting", (img,), dict(alpha_std=0.0), 1e-6),
    ]


def _det_op_checks(torch, mx, card="cuda"):
    """Every case of _det_op_cases on the card against the CPU."""
    from mxnet_tpu_torch.ops import registry
    out, ok = {}, True
    for name, args, kw, tol in _det_op_cases(np.random.RandomState(5)):
        fn = registry.get_op(name).fn
        res = []
        for d in (card, "cpu"):
            r = fn(*[torch.from_numpy(np.ascontiguousarray(a)).to(d)
                     for a in args], **kw)
            res.append(r if isinstance(r, tuple) else (r,))
        err = 0.0
        for g, w in zip(*res):
            g, w = g.cpu().double(), w.double()
            scale = max(float(w.abs().max()), 1.0) if w.numel() else 1.0
            err = max(err, float((g - w).abs().max()) / scale
                      if w.numel() else 0.0)
        out[name] = err
        ok = ok and err <= tol
        if err > tol:
            out[name + ".tolerance"] = tol
    return ok, out


def phase_train_det(torch, state):
    """Path train_det: the SSD example trained and served on the card."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import box_nms as NMS
    folder = tempfile.mkdtemp(prefix="chip_smoke_det_")
    gpu, cpu = mx.gpu(0), mx.cpu()
    try:
        # -- the main path: train, then detect, counters zeroed just before
        import random
        random.seed(0)
        np.random.seed(0)
        mx.random.seed(0)
        NMS.LAUNCHES = 0
        t0 = time.perf_counter()
        net, losses = ssd_train_from_rec(mx, folder, gpu)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        x_np, lab_np = ssd_make_batch(np.random.RandomState(99), batch=2)
        x = mx.nd.array(x_np, ctx=gpu)
        # f32 on both sides for the card-vs-CPU check: no TF32 in cuDNN
        with mx.precision.matmul_precision("float32"):
            dets = ssd_detect(mx, net, x).asnumpy()
        launches_path = NMS.LAUNCHES
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    # the same call on the CPU with the trained weights
    arrays = {k: p.data().asnumpy() for k, p in
              net._collect_params_with_prefix().items()}
    with cpu:
        net_cpu = ssd_tiny(mx)
        net_cpu.initialize(ctx=cpu)
        net_cpu(mx.nd.array(x_np, ctx=cpu))
        from mxnet_tpu_torch import convert
        convert.load_numpy_params(net_cpu, arrays)
        with mx.precision.matmul_precision("float32"):
            dets_cpu = ssd_detect(mx, net_cpu, mx.nd.array(
                x_np, ctx=cpu)).asnumpy()
    A = dets.shape[1]
    ok_shape = dets.shape == (2, A, 6) and A == (32 // 4) ** 2 * 4
    live = dets[..., 0] >= 0
    # survivors first, then -1 rows
    ok_rows = bool(all(np.all(live[i][:live[i].sum()]) for i in range(2))
                   and np.all(dets[~live] == -1.0))
    det_err = float(np.abs(dets - dets_cpu).max())
    ok_det = bool(np.array_equal(dets[..., :1], dets_cpu[..., :1])
                  and det_err <= DET_RTOL * max(
                      1.0, float(np.abs(dets_cpu).max())))
    top_iou = []
    for i in range(2):
        if live[i].any():
            b = dets[i, 0, 2:6]
            g = lab_np[i, 0, 1:5]
            iw = max(0.0, min(b[2], g[2]) - max(b[0], g[0]))
            ih = max(0.0, min(b[3], g[3]) - max(b[1], g[1]))
            inter = iw * ih
            union = (b[2] - b[0]) * (b[3] - b[1]) + \
                (g[2] - g[0]) * (g[3] - g[1]) - inter
            top_iou.append(float(inter / union) if union > 0 else 0.0)
    ok_train = bool(all(np.isfinite(losses))
                    and losses[-1] < SSD_LOSS_RATIO * losses[0])
    ok_300, res_300, kept_300, launches_300 = _ssd300_ops(torch, mx, state)
    ok_ops, op_errs = _det_op_checks(torch, mx)
    state.setdefault("launches", {})["box_nms"] = launches_path + \
        launches_300
    emit({"phase": "train_det", "card": state["smi"],
          "epochs": SSD_EPOCHS, "sgd": SSD_SGD, "epoch_losses": losses,
          "train_wall_s": train_s,
          "loss_ratio_last_first": losses[-1] / losses[0],
          "detect_shape": list(dets.shape), "detect_rows_ok": ok_rows,
          "detect_card_vs_cpu_max_abs": det_err,
          "top_detection_iou_with_square": top_iou,
          "box_nms_launches": {"train_det_detect": launches_path,
                               "ssd300_ops": launches_300},
          "kernels_of_rows_1_15": 0,
          "ssd300": {"anchors": SSD300_ANCHORS, "batch": SSD300_BATCH,
                     "classes": SSD300_CLASSES, "gt_rows": SSD300_GT,
                     "kept_detections_batch": kept_300, **res_300},
          "other_ops_card_vs_cpu_rel_err": op_errs,
          "ok": bool(ok_train and ok_shape and ok_rows and ok_det
                     and ok_300 and ok_ops)})
    if not ok_train:
        raise AssertionError("train_det: last epoch loss %.4f not below "
                             "%.1f x the first's %.4f"
                             % (losses[-1], SSD_LOSS_RATIO, losses[0]))
    if not (ok_shape and ok_rows and ok_det):
        raise AssertionError("train_det: detect shape %s, rows %s, card vs "
                             "CPU %.3g" % (dets.shape, ok_rows, det_err))
    if not ok_300:
        raise AssertionError("train_det: SSD300-scale box ops %s" % res_300)
    if not ok_ops:
        raise AssertionError("train_det: ops card vs CPU %s" % op_errs)
    if launches_path < 1:
        raise AssertionError("train_det: detect did not launch box_nms")


# -- phase api: the M3b names on the card against the CPU ---------------------
# f32, elementwise formulas on both devices: within 1e-5 of the largest
# magnitude (exp/log differ by an ulp); CTC: PyTorch's CUDA and CPU
# ctc_loss sum the alpha recursion in other orders, within 1e-4
API_RTOL = 1e-5
API_CTC_RTOL = 1e-4


def _api_losses():
    """(loss class name, constructor kwargs, numpy inputs, differentiated
    positions, tolerance) for every loss added to the port."""
    rs = np.random.RandomState(0)
    p, l = rs.randn(8, 5).astype("f4"), rs.randn(8, 5).astype("f4")
    sign = np.sign(l).astype("f4")
    binary = (l > 0).astype("f4")
    prob = (1 / (1 + np.exp(-p))).astype("f4")
    dist = rs.dirichlet(np.ones(5), 8).astype("f4")
    sw = (rs.rand(8, 1) + 0.5).astype("f4")
    ctc_pred = rs.randn(4, 12, 7).astype("f4")
    ctc_label = rs.randint(1, 7, (4, 5)).astype("f4")
    ctc_label[1, 3:] = -1
    cases = [("L2Loss", {}, [p, l, sw]), ("L1Loss", {"weight": 2.0}, [p, l]),
             ("HuberLoss", {"rho": 0.5}, [p, l]), ("HingeLoss", {}, [p, sign]),
             ("SquaredHingeLoss", {}, [p, sign]),
             ("LogisticLoss", {}, [p, sign]),
             ("LogisticLoss", {"label_format": "binary"}, [p, binary]),
             ("SigmoidBinaryCrossEntropyLoss", {}, [p, binary, sw]),
             ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
              [prob, binary]),
             ("KLDivLoss", {"from_logits": False}, [p, dist]),
             ("PoissonNLLLoss", {"compute_full": True},
              [p, rs.poisson(2.0, (8, 5)).astype("f4")]),
             ("CosineEmbeddingLoss", {}, [p, l, np.where(
                 rs.rand(8) > 0.5, 1, -1).astype("f4")])]
    out = [(n, k, a, (0,), API_RTOL) for n, k, a in cases]
    out.append(("TripletLoss", {}, [p, l, rs.randn(8, 5).astype("f4")],
                (0, 1, 2), API_RTOL))
    out.append(("CTCLoss", {}, [ctc_pred, ctc_label], (0,), API_CTC_RTOL))
    out.append(("CTCLoss", {"layout": "NTC"},
                [ctc_pred, ctc_label, np.array([12, 9, 11, 10], "f4"),
                 np.array([5, 3, 4, 2], "f4")], (0,), API_CTC_RTOL))
    return out


def _rel_err(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _on(torch, device, arrays, diff):
    ts = [torch.from_numpy(a).to(device) for a in arrays]
    for i in diff:
        ts[i].requires_grad_()
    return ts


def _api_loss_checks(torch, mx):
    res = {}
    for name, kw, arrays, diff, tol in _api_losses():
        outs = {}
        for device in ("cpu", "cuda"):
            block = getattr(mx.gluon.loss, name)(**kw)
            ts = _on(torch, device, arrays, diff)
            with mx.autograd.record():
                val = block(*ts)
            grads = torch.autograd.grad(val.sum(), [ts[i] for i in diff])
            outs[device] = [val] + list(grads)
        err = max(_rel_err(c, h) for c, h in zip(outs["cuda"], outs["cpu"]))
        res["%s%s" % (name, sorted(kw.items()) or "")] = (err, tol)
    return res


def _api_flow_checks(torch, mx):
    """autograd.Function, foreach, while_loop and cond: outputs and input
    gradients, card against CPU."""
    rs = np.random.RandomState(1)
    x_np, w_np = rs.randn(6, 4).astype("f4"), rs.randn(4).astype("f4")

    class ScaledSigmoid(mx.autograd.Function):
        def forward(self, x, w):
            y = 1.0 / (1.0 + mx.nd.exp(-x))
            self.save_for_backward(y, w)
            return y * w

        def backward(self, dy):
            y, w = self.saved_tensors
            return dy * w * y * (1.0 - y), (dy * y).sum(axis=0)

    def function(x, w):
        return [ScaledSigmoid()(x, w)]

    def foreach(x, w):
        outs, st = mx.nd.contrib.foreach(
            lambda d, s: (mx.nd.tanh(d * s[0]), [s[0] + d]), x, [w])
        return [outs, st[0]]

    def while_loop(x, w):
        i0 = mx.nd.zeros((1,), ctx=x.context)
        outs, (_, v) = mx.nd.contrib.while_loop(
            lambda i, v: i < 3, lambda i, v: ([v * w], [i + 1, v * 0.5 + w]),
            [i0, x[0]], max_iterations=5)
        return [outs[0], v]

    def cond(x, w):
        return [mx.nd.contrib.cond(x.sum() > 0, lambda: x * w,
                                   lambda: x - w)]

    res = {}
    for name, fn in (("autograd.Function", function), ("foreach", foreach),
                     ("while_loop", while_loop), ("cond", cond)):
        outs = {}
        for key, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu(0))):
            x = mx.nd.array(x_np, ctx=ctx)
            w = mx.nd.array(w_np, ctx=ctx)
            for v in (x, w):
                v.attach_grad()
            with mx.autograd.record():
                ys = fn(x, w)
                head = sum((y * (k + 1.0)).sum() for k, y in enumerate(ys))
            head.backward()
            outs[key] = [y._data for y in ys] + [x.grad._data,
                                                w.grad._data]
        res[name] = (max(_rel_err(c, h) for c, h in
                         zip(outs["gpu"], outs["cpu"])), API_RTOL)
    return res


def phase_api(torch, state):
    """Path api: the losses, autograd.Function, nd.contrib control flow,
    gluon.Constant, Context.empty_cache and type-object dtypes on the card,
    each against the port on the CPU."""
    import mxnet_tpu_torch as mx
    checks = _api_loss_checks(torch, mx)
    checks.update(_api_flow_checks(torch, mx))
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}

    gpu = mx.gpu(0)
    const = mx.gluon.Constant("const", np.arange(6.0).reshape(2, 3))
    w = mx.gluon.Parameter("w", shape=(2, 3))
    const.initialize(ctx=gpu)
    w.initialize(init=mx.init.One(), ctx=gpu)
    trainer = mx.gluon.Trainer([w, const], "sgd", {"learning_rate": 0.5})
    with mx.autograd.record():
        loss = (w.data() * const.data()).sum()
    loss.backward()
    trainer.step(1)
    ok_const = bool((const.data().asnumpy() == np.arange(6.0).reshape(2, 3))
                    .all()) and const.list_ctx() == [gpu] and \
        bool(np.allclose(w.data().asnumpy(),
                         1 - 0.5 * np.arange(6.0).reshape(2, 3)))

    torch.cuda.synchronize()
    big = torch.empty(1 << 30, dtype=torch.uint8, device=gpu.device)
    del big
    before = torch.cuda.memory_reserved()
    gpu.empty_cache()
    after = torch.cuda.memory_reserved()
    ok_cache = after < before

    z = mx.nd.zeros((2, 3), dtype=np.float16, ctx=gpu)
    ok_dtype = z._data.dtype == torch.float16 and z._data.is_cuda \
        and z.wait_to_write() is z

    emit({"phase": "api", "card": state["smi"],
          "card_vs_cpu_rel_err": {k: v[0] for k, v in checks.items()},
          "tolerance": {k: v[1] for k, v in checks.items()},
          "constant_unchanged_by_trainer": ok_const,
          "memory_reserved_bytes": {"before_empty_cache": before,
                                    "after": after},
          "zeros_float16_on_gpu": ok_dtype,
          "ok": not bad and ok_const and ok_cache and ok_dtype})
    if bad:
        raise AssertionError("api: card vs CPU past tolerance: %s" % bad)
    if not ok_const:
        raise AssertionError("api: Trainer.step changed a Constant")
    if not ok_cache:
        raise AssertionError("api: empty_cache left memory_reserved at %d "
                             "(was %d)" % (after, before))
    if not ok_dtype:
        raise AssertionError("api: nd.zeros(dtype=np.float16, ctx=gpu(0)) "
                             "gave %s on %s" % (z._data.dtype,
                                                z._data.device))


LM_DEEP_CFG = dict(vocab_size=32000, dim=2048, n_layers=24, n_heads=16,
                   ffn_hidden=8192, max_seq_len=2048, dtype="bfloat16",
                   attn_mode="local", loss_chunks=8, remat=True,
                   remat_save=())
LM_DEEP_BATCH, LM_DEEP_SEQ = 8, 2048
LM_DEEP_STEPS = 3
# Flash launches per step by remat_save: full recompute runs the forward
# again in each layer's recompute; with "attn_o" kept it does not.
_DEEP_L = LM_DEEP_CFG["n_layers"]
LM_DEEP_SAVES = {(): {"fwd": 2 * _DEEP_L, "dq": _DEEP_L, "dkv": _DEEP_L},
                 ("attn_o",): {"fwd": _DEEP_L, "dq": _DEEP_L,
                               "dkv": _DEEP_L}}
# The flash kernels at the deep LM's attention (batch cut from 8 to 1, as
# the LM passes them: [B, S, H, D] buffers seen transposed).
FLASH_DEEP = (1, 16, 2048, 2048, 128, True)


def _save_key(save):
    return "remat_save=%s" % (",".join(save) or "()")


def phase_train_lm_deep(torch, state):
    """The deep LM's steps (the module docstring, phase 6b)."""
    import dataclasses
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.parallel import transformer as T

    res, _, _ = flash_check(torch, FLASH_DEEP, torch.bfloat16, 1200, "bshd")
    bad = {n: r for n, r in res.items() if not r["ok"]}
    emit({"phase": "train_lm_deep", "kernel": "flash_attention",
          "shape_bhsd": list(FLASH_DEEP[:5]), "layout": "bshd",
          "batch_cut_from": LM_DEEP_BATCH, "results": res,
          "tolerance_rel": FLASH_RTOL["bfloat16"], "ok": not bad})
    if bad:
        raise AssertionError("flash kernels at the deep LM's shape: %s"
                             % bad)
    torch.cuda.empty_cache()

    gpu = mx.gpu(0)
    cfg = T.TransformerConfig(**LM_DEEP_CFG)
    init_fn, _ = T.make_train_step(cfg, learning_rate=LM_LR, ctx=gpu)
    t0 = time.perf_counter()
    lm = init_fn(0)
    tok, tgt = _lm_batch(torch, cfg.vocab_size, LM_DEEP_BATCH, LM_DEEP_SEQ,
                         0, gpu.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = T.n_params(lm[0])
    tokens = LM_DEEP_BATCH * LM_DEEP_SEQ
    peak_flops = state["card"][1][0]
    runs, all_losses, failures = {}, [], []
    for save, want1 in LM_DEEP_SAVES.items():
        key = _save_key(save)
        _, step_fn = T.make_train_step(
            dataclasses.replace(cfg, remat_save=save),
            learning_rate=LM_LR, ctx=gpu)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in FA.LAUNCHES:
            FA.LAUNCHES[k] = 0
        losses = []
        t0 = time.perf_counter()
        for _ in range(LM_DEEP_STEPS):
            lm, loss = step_fn(lm, tok, tgt)
            losses.append(float(loss))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(FA.LAUNCHES)
        want = {k: LM_DEEP_STEPS * v for k, v in want1.items()}
        peak = torch.cuda.max_memory_allocated()
        all_losses += losses

        def one_step(step_fn=step_fn):
            step_fn(lm, tok, tgt)
        busy_ms, by_kernel, tops = profile_busy_ms(
            torch, one_step, 1, top=10,
            match=("flash_fwd", "flash_dq", "flash_dkv"))
        wall_ms = host_ms(torch, one_step, 2)
        tflops = 6.0 * n * tokens / (wall_ms / 1e3) / 1e12
        runs[key] = {
            "losses": losses, "launches": counts, "launches_wanted": want,
            "max_memory_allocated_bytes": peak, "wall_s_3_steps": wall,
            "wall_ms_per_step": wall_ms,
            "tokens_per_sec": tokens / (wall_ms / 1e3),
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": None if busy_ms is None
            else max(0.0, 1.0 - busy_ms / wall_ms),
            "model_tflops_per_sec": tflops,
            "mfu": tflops * 1e12 / peak_flops,
            "flash_kernel_ms_per_step_by_name": by_kernel}
        if counts != want:
            failures.append((key, "launches", counts, want))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            failures.append((key, "loss", losses))
        if tops:
            emit(dict({"phase": "train_lm_deep",
                       "where_the_time_goes": key}, **tops))
    if not all_losses[-1] < all_losses[0]:
        failures.append(("loss over both runs", all_losses))
    state["launches_lm_deep"] = {k: r["launches"] for k, r in runs.items()}
    state["lm_deep_timing"] = runs
    emit({"phase": "train_lm_deep", "card": state["smi"],
          "config": LM_DEEP_CFG, "batch": LM_DEEP_BATCH, "seq": LM_DEEP_SEQ,
          "learning_rate": LM_LR, "params": n, "init_s": init_s,
          "steps_per_run": LM_DEEP_STEPS, "runs": runs,
          "ok": not failures})
    del lm, tok, tgt, step_fn
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("deep LM: %s" % failures)
    _lm_f32_card_vs_cpu(torch, mx, T, {"attn_mode": "blockwise"},
                        "train_lm_deep")


def phase_time_conv_fwd(torch, state):
    """Row 1 at the four serving shapes (bf16, batch 32, relu): the kernel
    (the wrapper's whole call), the plain version, the library yardstick
    (cuDNN's convolution after relu(x*s + b) in torch, channels-last) and
    cuDNN's convolution alone, beside the bound, with fwd_plan's nb and
    items (null in a tree without fwd_plan)."""
    import torch.nn.functional as tF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    card = state["card"]
    plan = getattr(CF, "fwd_plan", None)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "cudnn_conv_only_ms": 0.0, "bound_ms": 0.0,
              "bound_ops_ms": 0.0}
    for i, (shape, count) in enumerate(RN50_SHAPES):
        x, s, b, w = make_case(torch, shape, torch.bfloat16, seed=200 + i)
        sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
        x_cf = x.permute(0, 3, 1, 2)                       # channels-last
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            z = torch.relu(x_cf * sb.view(1, -1, 1, 1) + bb.view(1, -1, 1, 1))
            return tF.conv2d(z, w_cl, padding=1)

        def conv_only():
            return tF.conv2d(x_cf, w_cl, padding=1)

        k_ms = device_ms(torch, lambda: CF.fused_scale_relu_conv3x3(
            x, s, b, w), iters=100)
        p_ms = device_ms(torch, lambda: CF.fused_conv_reference(
            x, s, b, w), iters=10)
        l_ms = device_ms(torch, library, iters=50)
        c_ms = device_ms(torch, conv_only, iters=50)
        t_bound, by = bound(shape, 2, card)
        b_ms = t_bound * 1e3
        fp = None if plan is None else plan(*shape, CF._sm_count(x.device))
        emit({"phase": "time", "kernel": "conv_fused", "dtype": "bfloat16",
              "shape": list(shape), "launches_per_forward": count,
              "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "cudnn_conv_only_ms": c_ms, "bound_ms": b_ms, "bound_by": by,
              "roofline_share": roofline_share(
                  b_ms, k_ms, "conv_fused forward %s" % (shape,)),
              "fwd_plan": None if fp is None else {"nb": fp.nb,
                                                   "items": fp.items,
                                                   "grid": fp.grid}})
        totals["ms"] += count * k_ms
        totals["plain_ms"] += count * p_ms
        totals["library_ms"] += count * l_ms
        totals["cudnn_conv_only_ms"] += count * c_ms
        totals["bound_ms"] += count * b_ms
        if by == "operations":
            totals["bound_ops_ms"] += count * b_ms
        del x, s, b, w, x_cf, w_cl
    totals["bound_by"] = "operations" \
        if totals.pop("bound_ops_ms") >= totals["bound_ms"] / 2 else "bytes"
    state["timing"] = totals
    emit({"phase": "time", "kernel": "conv_fused",
          "per_forward_bf16_b32": totals})


def phase_time(torch, state):
    import mxnet_tpu_torch as mx

    phase_time_conv_fwd(torch, state)
    # whole forward, bf16, fused and unfused, batch resident on the card:
    # host wall clock (what an eager caller sees) and, from the profiler,
    # the device's busy time per forward and its idle share
    arrays = state["arrays"]
    rates = {}
    for fuse in (True, False):
        net = _build_net(mx, arrays, fuse, "bfloat16", mx.gpu(0))
        for batch, iters in ((32, 20), (256, 5)):
            x = torch.rand(batch, 3, 224, 224, device="cuda",
                           dtype=torch.bfloat16)
            for _ in range(3):
                net(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                net(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            busy_ms, by_kernel, ops = profile_busy_ms(
                torch, lambda: net(x), 3, top=10 if batch == 32 else None)
            rates["fuse=%s,b%d" % (fuse, batch)] = {
                "images_per_sec": batch * iters / wall,
                "wall_ms_per_forward": wall / iters * 1e3,
                "device_busy_ms_per_forward": busy_ms,
                "device_idle_share": None if busy_ms is None
                else max(0.0, 1.0 - busy_ms / (wall / iters * 1e3)),
                "conv_fused_ms_per_forward": None if by_kernel is None
                else by_kernel["conv_fused"]}
            if ops:
                emit({"phase": "time", "where_the_time_goes":
                      "fuse=%s,b%d" % (fuse, batch),
                      "top_ops": ops["top_ops"]})
        del net
    emit({"phase": "time", "resnet50_v1_nhwc_bf16": rates})
    phase_time_bn(torch, state)
    phase_time_conv_bwd(torch, state)
    phase_time_apply(torch, state)
    phase_time_codec(torch, state)
    phase_time_adam(torch, state)
    phase_time_train(torch, state)
    phase_time_flash(torch, state)
    phase_time_lm(torch, state)
    phase_time_int8(torch, state)


def phase_time_bn(torch, state):
    """Each BatchNorm kernel at the nine training shapes (bf16, act None):
    kernel, plain version and library call, beside the bound."""
    import torch.nn.functional as tF
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF

    card = state["card"]
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bound_ops_ms": 0.0} for k in BN_KERNELS}
    pair_lib = {"forward": 0.0, "backward": 0.0}
    for i, (shape, count) in enumerate(BN_SHAPES):
        N, H, W, C = shape
        R = N * H * W
        x2, g, b, dy = bn_case(torch, R, C, torch.bfloat16, seed=500 + i)
        mean, var = BNF.stats_reference(x2)
        db, dg = BNF.bwd_reduce_reference(x2, dy, g, b, mean, var, BN_EPS)
        inv = BNF.inv_std(var, BN_EPS)
        x_cf = x2.view(N, H, W, C).permute(0, 3, 1, 2)   # channels-last
        dy_cf = dy.view(N, H, W, C).permute(0, 3, 1, 2)
        bwd = torch.ops.aten.native_batch_norm_backward
        runs = {
            "stats": (lambda: BNF.stats(x2),
                      lambda: BNF.stats_reference(x2),
                      lambda: torch.var_mean(x_cf, dim=(0, 2, 3),
                                             correction=0)),
            "apply": (lambda: BNF.apply(x2, g, b, mean, var, BN_EPS),
                      lambda: BNF.apply_reference(x2, g, b, mean, var,
                                                  BN_EPS),
                      lambda: tF.batch_norm(x_cf, mean, var, g, b,
                                            training=False, eps=BN_EPS)),
            "bwd_reduce": (
                lambda: BNF.bwd_reduce(x2, dy, g, b, mean, var, BN_EPS),
                lambda: BNF.bwd_reduce_reference(x2, dy, g, b, mean, var,
                                                 BN_EPS),
                lambda: bwd(dy_cf, x_cf, g, None, None, mean, inv, True,
                            BN_EPS, [False, True, True])),
            "bwd_dx": (
                lambda: BNF.bwd_dx(x2, dy, g, b, mean, var, db, dg, BN_EPS),
                lambda: BNF.bwd_dx_reference(x2, dy, g, b, mean, var, db,
                                             dg, BN_EPS),
                lambda: bwd(dy_cf, x_cf, g, None, None, mean, inv, True,
                            BN_EPS, [True, False, False])),
        }
        row = {}
        for k, (kern, plain, lib) in runs.items():
            t_bound, by = bn_bound(shape, k, 2, card)
            row[k] = {"ms": device_ms(torch, kern, iters=20),
                      "plain_ms": device_ms(torch, plain, iters=3, warmup=1),
                      "library_ms": device_ms(torch, lib, iters=20),
                      "bound_ms": t_bound * 1e3, "bound_by": by}
            row[k]["roofline_share"] = roofline_share(
                row[k]["bound_ms"], row[k]["ms"],
                "batchnorm_fused %s %s" % (k, shape))
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                totals[k][f] += count * row[k][f]
            if by == "operations":
                totals[k]["bound_ops_ms"] += count * row[k]["bound_ms"]
        fwd_lib = device_ms(torch, lambda: tF.batch_norm(
            x_cf, None, None, g, b, training=True, eps=BN_EPS), iters=20)
        bwd_lib = device_ms(torch, lambda: bwd(
            dy_cf, x_cf, g, None, None, mean, inv, True, BN_EPS,
            [True, True, True]), iters=20)
        pair_lib["forward"] += count * fwd_lib
        pair_lib["backward"] += count * bwd_lib
        plan = getattr(BNF, "_plan", None)
        emit({"phase": "time", "kernel": "batchnorm_fused",
              "dtype": "bfloat16", "shape_nhwc": list(shape), "R": R,
              "C": C, "launches_per_step": count, "kernels": row,
              "library_forward_ms": fwd_lib, "library_backward_ms": bwd_lib,
              "folds": {k: {"ms": row[k]["ms"],
                            "share": row[k]["roofline_share"],
                            "fold_plan": plan(k, x2)._asdict() if plan
                            else None} for k in ("stats", "bwd_reduce")}})
        del x2, g, b, dy, x_cf, dy_cf
    for k in BN_KERNELS:
        t = totals[k]
        t["bound_by"] = "operations" \
            if t.pop("bound_ops_ms") >= t["bound_ms"] / 2 else "bytes"
    state["bn_timing"] = totals
    emit({"phase": "time", "kernel": "batchnorm_fused",
          "design": {k: BN_FOLD_DESIGN for k in ("stats", "bwd_reduce")},
          "per_step_bf16_b128": totals,
          "library_per_step_ms": {
              "forward_batch_norm_training": pair_lib["forward"],
              "backward_native_batch_norm_backward": pair_lib["backward"]}})
    torch.cuda.empty_cache()


def conv_bwd_bound(shape, kernel, dtype_bytes, card):
    """Least time (s) for one launch of a conv_fused backward kernel, and
    which side bounds it: 2*N*H*W*9*Ci*Co operations over the peak for the
    dtype; bytes over the memory rate: the d-input kernel reads x, dy, W,
    s, b and writes dx, ds, db; the d-weight kernel reads x, dy, s, b and
    writes dW."""
    N, H, W, Ci, Co = shape
    _, (bf16_peak, f32_peak, bw) = card
    ops = 2.0 * N * H * W * 9 * Ci * Co
    px = N * H * W
    if kernel == "bwd_dx":
        nbytes = dtype_bytes * (px * (2 * Ci + Co) + 9 * Ci * Co) + 16 * Ci
    else:
        nbytes = dtype_bytes * (px * (Ci + Co) + 9 * Ci * Co) + 8 * Ci
    t_ops = ops / (bf16_peak if dtype_bytes == 2 else f32_peak)
    t_bytes = nbytes / bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_time_conv_bwd(torch, state):
    """Rows 2 and 3 at the four fused shapes of training at batch 128
    (bf16, relu): each kernel with its second pass (profiler, by name), the
    whole backward call, the plain halves, and the library yardstick
    ``aten.convolution_backward`` for the input and the weight gradient
    apart (the convolution only: no mask, no scale, no ds/db)."""
    from mxnet_tpu_torch.kernels import conv_fused as CF

    card = state["card"]
    lib = torch.ops.aten.convolution_backward
    plain = {"bwd_dx": CF.backward_input_reference,
             "bwd_dw": CF.backward_weight_reference}
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bound_ops_ms": 0.0} for k in CONV_BWD}
    call_total = 0.0
    for i, (shape, count) in enumerate(RN50_TRAIN_SHAPES):
        x, s, b, w, dy = conv_bwd_case(torch, shape, torch.bfloat16,
                                       seed=900 + i)
        x_cf = x.permute(0, 3, 1, 2)                       # channels-last
        dy_cf = dy.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        libs = {k: (lambda mask=mask: lib(dy_cf, x_cf, w_cl, None, [1, 1],
                                          [1, 1], [1, 1], False, [0, 0], 1,
                                          mask))
                for k, mask in (("bwd_dx", [True, False, False]),
                                ("bwd_dw", [False, True, False]))}
        call = (lambda: CF.fused_conv_backward(x, s, b, w, dy))
        groups = {k: names for k, (_, names, _) in CONV_BWD.items()}
        for k, part in (("bwd_dx", "dx"), ("bwd_dw", "dw")):
            names = CONV_BWD[k][1]
            groups.update({part + "_kernel": names[:1],
                           part + "_second_pass": names[1:]})
        k_ms = kernel_ms(torch, call, 10, groups)
        c_ms = device_ms(torch, call, iters=20)
        call_total += count * c_ms
        row = {}
        for k in CONV_BWD:
            t_bound, by = conv_bwd_bound(shape, k, 2, card)
            row[k] = {"ms": k_ms[k],
                      "plain_ms": device_ms(torch, lambda k=k: plain[k](
                          x, s, b, w, dy), iters=5, warmup=1),
                      "library_ms": device_ms(torch, libs[k], iters=20),
                      "bound_ms": t_bound * 1e3, "bound_by": by}
            row[k]["roofline_share"] = roofline_share(
                row[k]["bound_ms"], row[k]["ms"],
                "conv_fused %s %s" % (k, shape))
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                totals[k][f] += count * row[k][f]
            if by == "operations":
                totals[k]["bound_ops_ms"] += count * row[k]["bound_ms"]
        emit({"phase": "time", "kernel": "conv_fused_backward",
              "dtype": "bfloat16", "shape": list(shape),
              "launches_per_step": count, "kernels": row,
              "dx_kernel_ms": k_ms["dx_kernel"],
              "dx_finalize_ms": k_ms["dx_second_pass"],
              "dx_plan": CF.dx_plan(*shape, CF._sm_count(x.device))
              ._asdict(),
              "dw_kernel_ms": k_ms["dw_kernel"],
              "dw_reduce_ms": k_ms["dw_second_pass"],
              "dw_plan": CF.dw_plan(*shape, torch.bfloat16,
                                    CF._sm_count(x.device))._asdict(),
              "whole_backward_call_ms": c_ms})
        del x, s, b, w, dy, x_cf, dy_cf, w_cl
    for k in CONV_BWD:
        t = totals[k]
        t["bound_by"] = "operations" \
            if t.pop("bound_ops_ms") >= t["bound_ms"] / 2 else "bytes"
    state["conv_bwd_timing"] = totals
    emit({"phase": "time", "kernel": "conv_fused_backward",
          "per_step_bf16_b128": totals,
          "whole_backward_calls_ms_per_step": call_total})
    torch.cuda.empty_cache()


def phase_time_apply(torch, state):
    """Row 8 over ResNet-50's trainable parameters in bf16 with momentum,
    as the fused step runs it (lr 0.01, wd 0): the kernel launches of one
    update phase (profiler, by name), the whole packed_apply call (with
    its segment-table uploads), the plain version over the packed
    segments, the concatenate-and-split copies that a packing
    implementation would add around it (this kernel has none), and the
    per-parameter update phase that MXTPU_FUSED_APPLY=0 runs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    card = state["card"]
    shapes = _train_shapes(mx, state)
    opt = topt.SGD(**SGD)
    ws, gs, ms, _, _ = apply_case(torch, shapes, torch.bfloat16, 0.9,
                                  seed=950)
    lrs = [SGD["learning_rate"]] * len(ws)
    wds = [0.0] * len(ws)
    rescale = 1.0 / 128
    segs = _packed_segments(torch, OA, ws, gs, ms, lrs, wds)

    def run():
        OA.packed_apply(opt, ws, gs, ms, lrs, wds, rescale)

    def pack_unpack():
        for bucket, *_ in segs:
            for ts in (ws, gs, ms):
                torch.cat([ts[i].reshape(-1) for i in bucket])
        for (bucket, w, _, m, _, _) in segs:
            off = 0
            for i in bucket:
                n = ws[i].numel()
                ws[i].view(-1).copy_(w[off:off + n])
                ms[i].view(-1).copy_(m[off:off + n])
                off += n

    def per_param():
        with torch.no_grad():
            for w, g, m, lr, wd in zip(ws, gs, ms, lrs, wds):
                nw, nm = opt.step_fn_multi_precision(w, g, m, lr, wd,
                                                     rescale)
                w.copy_(nw)
                m.copy_(nm)

    n = sum(w.numel() for w in ws)
    _, (_, f32_peak, bw) = card
    t_bytes = (2 * 5 * n + 8 * len(ws)) / bw
    t_ops = APPLY_OPS * n / f32_peak
    # device times from the profiler (kernels and copies summed), since
    # these calls make tens to thousands of launches and an event pair
    # would also count the host's gaps between them; host times beside
    res = {"ms": kernel_ms(torch, run, 10, {"k": ("sgd_apply",)})["k"],
           "call_ms": device_busy_ms(torch, run, 10),
           "call_host_ms": host_ms(torch, run, 10),
           "plain_ms": device_busy_ms(torch, lambda: apply_plain(
               torch, OA, opt, segs, rescale), 5),
           "pack_unpack_copies_ms": device_busy_ms(torch, pack_unpack, 5),
           "per_param_update_phase_ms": device_busy_ms(torch, per_param, 5),
           "per_param_update_phase_host_ms": host_ms(torch, per_param, 5),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None,
           "library_note": "no single PyTorch call computes MXNet's SGD "
                           "step (rescale, clip, wd, momentum as one op)",
           "tensors": len(ws), "elements": n, "buckets": len(segs)}
    res["roofline_share"] = roofline_share(res["bound_ms"], res["ms"],
                                           "optimizer_apply SGD")
    state["apply_timing"] = res
    emit({"phase": "time", "kernel": "optimizer_apply", "dtype": "bfloat16",
          "per_step": res})
    del ws, gs, ms, segs
    torch.cuda.empty_cache()


def phase_time_codec(torch, state):
    """Rows 14-15 over one train_kv step's pushes: the 54 compressed
    ResNet-50 gradients in bf16 (threshold 0.5) in the form the store runs
    them, one grouped call of each kernel (quantize_2bit_group, then
    dequantize_2bit_group of its words), or, in a tree whose codec has no
    grouped calls, one call per tensor: the kernels' device time by name
    (profiler), the whole calls' device and host time, the plain versions'
    device time, the launches and segments of a step, and the bound
    (bytes: row 14 reads the gradient and the residual and writes the
    residual and 1/16 of a 4-byte word per value, 6.25 bytes in bf16; row
    15 reads 1/16 word and writes 4 bytes: 4.25). Per distinct size, each
    kernel's time for that tensor alone and its bound (and, for a grouped
    call, the size's share of it by bytes). No single PyTorch call packs
    2-bit codes. Then the store's part of a train_kv step: host and device
    ms of Trainer._allreduce_grads (the push and pull of the 161
    gradients) on the compressed kvstore, after one step at batch 16 has
    made the gradients."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import compression as C

    _, (_, f32_peak, bw) = state["card"]
    sizes = _kv_sizes(mx, state)
    thr = KV_COMPRESSION["threshold"]
    gen = torch.Generator(device="cuda").manual_seed(1500)
    gs = [(torch.randn(n, generator=gen, device="cuda") * 0.4)
          .to(torch.bfloat16) for n in sizes]
    rs = [(torch.randn(n, generator=gen, device="cuda") * 0.1)
          .to(torch.bfloat16) for n in sizes]
    grouped = hasattr(C, "quantize_2bit_group")
    if grouped:
        words = C.quantize_2bit_group(gs, rs, thr)[0]
        calls = {"quantize": lambda: C.quantize_2bit_group(gs, rs, thr),
                 "dequantize": lambda: C.dequantize_2bit_group(words, sizes,
                                                               thr)}
    else:
        words = [C.quantize_2bit(g, r, thr)[0] for g, r in zip(gs, rs)]
        calls = {"quantize": lambda: [C.quantize_2bit(g, r, thr)
                                      for g, r in zip(gs, rs)],
                 "dequantize": lambda: [C.dequantize_2bit(w, k, thr)
                                        for w, k in zip(words, sizes)]}
    plain = {"quantize": lambda: [C.quantize_2bit_reference(g, r, thr)
                                  for g, r in zip(gs, rs)],
             "dequantize": lambda: [C.dequantize_2bit_reference(w, k, thr)
                                    for w, k in zip(words, sizes)]}
    counters = {"quantize": ("LAUNCHES_QUANTIZE", "SEGMENTS_QUANTIZE"),
                "dequantize": ("LAUNCHES_DEQUANTIZE", "SEGMENTS_DEQUANTIZE")}
    n = sum(sizes)
    nw = sum(w.numel() for w in words)
    per_value = {"quantize": 3 * 2 + 4 / 16, "dequantize": 4 / 16 + 4}
    res = {}
    for row, fn in calls.items():
        name = "codec_%s_kernel" % row
        before = [getattr(C, c, 0) for c in counters[row]]
        fn()
        launches, segments = [getattr(C, c, 0) - b
                              for c, b in zip(counters[row], before)]
        nbytes = (3 * 2 * n + 4 * nw) if row == "quantize" \
            else (4 * nw + 4 * n)
        t_bytes = nbytes / bw
        t_ops = 6 * n / f32_peak
        r = {"ms": kernel_ms(torch, fn, 10, {"k": (name,)})["k"],
             "call_ms": device_busy_ms(torch, fn, 10),
             "call_host_ms": host_ms(torch, fn, 10),
             "plain_ms": device_busy_ms(torch, plain[row], 3),
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": None,
             "library_note": "none: no single PyTorch call packs or "
                             "unpacks 2-bit codes",
             "form": "grouped" if grouped else "per tensor",
             "launches_per_step": launches,
             "segments_per_step": segments if grouped else launches,
             "elements": n, "bytes": nbytes}
        r["roofline_share"] = roofline_share(r["bound_ms"], r["ms"],
                                             "compression %s" % row)
        per_size = {}
        for size in sorted(set(sizes)):
            i = sizes.index(size)
            one = (lambda i=i: C.quantize_2bit(gs[i], rs[i], thr)) \
                if row == "quantize" else \
                (lambda i=i: C.dequantize_2bit(words[i], sizes[i], thr))
            b = per_value[row] * size / bw * 1e6
            per_size[size] = {
                "count": sizes.count(size),
                "alone_us": kernel_ms(torch, one, 20, {"k": (name,)})["k"]
                * 1e3,
                "bound_us": b,
                "grouped_share_us": r["ms"] * 1e3 * size / n if grouped
                else None}
        r["per_size"] = per_size
        res[row] = r
    del gs, rs, words
    torch.cuda.empty_cache()

    # the store's push and pull inside a compressed step
    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    net = _build_net(mx, arrays, False, "bfloat16", mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD),
                               kvstore=_compressed_kv(mx))
    _train_step(mx, net, trainer, SoftmaxCrossEntropyLoss(),
                torch.from_numpy(x_np[:16]).to("cuda", torch.bfloat16),
                torch.from_numpy(y_np[:16]).cuda())
    torch.cuda.synchronize()
    res["store"] = {
        "what": "Trainer._allreduce_grads: push and pull of the 161 "
                "gradients, 54 compressed",
        "host_ms": host_ms(torch, trainer._allreduce_grads, 10),
        "device_busy_ms": device_busy_ms(torch, trainer._allreduce_grads, 5)}
    del net, trainer
    torch.cuda.empty_cache()
    state["codec_timing"] = res
    emit({"phase": "time", "kernel": "compression", "dtype": "bfloat16",
          "per_step": res})


def phase_time_adam(torch, state):
    """Row 8's Adam body over ResNet-50's trainable parameters in bf16 as
    train_adam runs it (update count 1): the kernel launches of one update
    phase (profiler, by name), the whole packed_apply call, the plain
    version over the packed segments, and as a yardstick
    torch._fused_adam_ over the same tensors (grad_scale = 1/rescale, eps /
    sqrt(1 - beta2^t): MXNet's update up to rounding, not bit-equal).
    Bound: bytes (w, g, m, v read, w, m, v written, 14 bytes per value in
    bf16)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA

    _, (_, f32_peak, bw) = state["card"]
    shapes = _train_shapes(mx, state)
    opt = topt.Adam(**ADAM)
    ws, gs, sts = adam_case(torch, shapes, torch.bfloat16, seed=960)
    for i in range(len(ws)):
        opt._index_update_count[i] = 1
    lrs = [opt.step_lr(i) for i in range(len(ws))]
    wds = [ADAM["wd"]] * len(ws)
    rescale = 1.0 / 128
    segs = _packed_segments(torch, OA, ws, gs, sts, lrs, wds)
    ms, vs = [st[0] for st in sts], [st[1] for st in sts]
    steps = [torch.ones((), device="cuda") for _ in ws]
    scale = torch.full((), 1.0 / rescale, device="cuda")
    eps = opt.epsilon / (1.0 - opt.beta2) ** 0.5

    def run():
        OA.packed_apply(opt, ws, gs, sts, lrs, wds, rescale)

    def library():
        torch._fused_adam_(ws, gs, ms, vs, [], steps, lr=ADAM["learning_rate"],
                           beta1=opt.beta1, beta2=opt.beta2,
                           weight_decay=ADAM["wd"], eps=eps, amsgrad=False,
                           maximize=False, grad_scale=scale, found_inf=None)

    n = sum(w.numel() for w in ws)
    t_bytes = (2 * 7 * n + 8 * 6 * len(ws)) / bw
    t_ops = ADAM_OPS * n / f32_peak
    res = {"ms": kernel_ms(torch, run, 10, {"k": ("adam_apply",)})["k"],
           "call_ms": device_busy_ms(torch, run, 10),
           "call_host_ms": host_ms(torch, run, 10),
           "plain_ms": device_busy_ms(torch, lambda: apply_plain(
               torch, OA, opt, segs, rescale), 3),
           "library_ms": device_busy_ms(torch, library, 10),
           "library_note": "torch._fused_adam_ (grad_scale 1/rescale, eps / "
                           "sqrt(1 - beta2^t)): the same update up to "
                           "rounding, not bit-equal",
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tensors": len(ws), "elements": n, "buckets": len(segs)}
    res["roofline_share"] = roofline_share(res["bound_ms"], res["ms"],
                                           "optimizer_apply Adam")
    state["adam_timing"] = res
    emit({"phase": "time", "kernel": "optimizer_apply.adam",
          "dtype": "bfloat16", "per_step": res})
    del ws, gs, sts, segs, ms, vs
    torch.cuda.empty_cache()


def phase_time_train(torch, state):
    """Both training steps at batch 128 in bf16 (the eager fuse=False step
    of phase train and the fused step of phase train_fused): images/sec
    from wall time, device busy time and idle share, device ms by kernel
    family, and the top host ops by device time."""
    for key, label in (("train", "train_step_resnet50_v1_nhwc_bf16_b128"),
                       ("train_kv", "compressed_kvstore_train_step_resnet50_"
                                    "v1_nhwc_bf16_b128"),
                       ("train_fused",
                        "fused_train_step_resnet50_v1_nhwc_bf16_b128"),
                       ("train_adam",
                        "fused_adam_train_step_resnet50_v1_nhwc_bf16_b128")):
        step = state.get(key)
        if step is None:
            continue
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        busy_ms, by_kernel, tops = profile_busy_ms(
            torch, step, 2, top=12,
            match=("bn_", "conv_fused_", "conv_bwd_dx_", "conv_bwd_finalize",
                   "conv_bwd_dw_", "conv_dw_reduce", "sgd_apply",
                   "adam_apply", "codec_quantize_kernel",
                   "codec_dequantize_kernel"))
        emit({"phase": "time", label: {
            "images_per_sec": 128 / wall, "wall_ms_per_step": wall * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": None if busy_ms is None
            else max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "kernel_ms_per_step_by_name": by_kernel}})
        if tops:
            emit(dict({"phase": "time",
                       "where_the_time_goes": key + ",b128"}, **tops))
    for key in ("sharded", "sharded_remat"):
        if key in state:
            _time_sharded(torch, state, key)


def _time_sharded(torch, state, key):
    """Phase train_sharded's step in one configuration: images/sec, device
    busy ms and idle share, peak memory (from its timed steps), and the
    update phase (the optimizer over every path, one at a time) on its
    own, device and host ms, beside train_fused's packed apply."""
    step, xd, yd, peak = state[key]

    def run():
        step.step(xd, yd)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    busy_ms, by_kernel, tops = profile_busy_ms(
        torch, run, 2, top=12,
        match=("bn_", "conv_fused_", "conv_bwd_dx_", "conv_bwd_finalize",
               "conv_bwd_dw_", "conv_dw_reduce"))
    grads = [torch.zeros_like(step.params[p]) for p in step._param_paths]

    def update():
        step._apply(grads, {})
    res = {"images_per_sec": 128 / wall, "wall_ms_per_step": wall * 1e3,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": None if busy_ms is None
           else max(0.0, 1.0 - busy_ms / (wall * 1e3)),
           "kernel_ms_per_step_by_name": by_kernel,
           "max_memory_allocated_bytes": peak,
           "update_phase_device_ms": device_busy_ms(torch, update, 3),
           "update_phase_host_ms": host_ms(torch, update, 3),
           "update_phase_paths": len(step._param_paths),
           "train_fused_packed_apply_ms":
               state.get("apply_timing", {}).get("ms")}
    state.setdefault("sharded_timing", {})[key] = res
    emit({"phase": "time", "sharded_train_step_resnet50_v1_nhwc_bf16_b128_"
          + key: res})
    if tops:
        emit(dict({"phase": "time",
                   "where_the_time_goes": key + ",b128"}, **tops))


def flash_bound(kernel, card, D=128):
    """Least time (s) of one launch of a flash kernel at the LM's attention
    (B 12, H 32, S 2048, head dim D (the LM's is 128), causal, bf16), and
    which side bounds it.
    Operations: one causal S x S x D product is B*H*S^2*D (half of
    2*B*H*S^2*D); the forward does 2 (QK^T, PV), dQ 3 (QK^T, dO V^T, dS K),
    dK/dV 4 (and P^T dO, dS^T Q). Bytes: each [B, H, S, D] input read once
    and output written once (forward: q, k, v in, o out; dQ: q, k, v, dO
    in, dQ out; dK/dV: q, k, v, dO in, dK, dV out), plus the f32 row
    vectors (lse; lse and delta)."""
    _, (bf16_peak, _, bw) = card
    B, H, S = LM_BATCH, LM_CFG["n_heads"], LM_SEQ
    product = float(B * H * S * S * D)
    ops = {"fwd": 2, "dq": 3, "dkv": 4}[kernel] * product
    tensors = {"fwd": 4, "dq": 5, "dkv": 6}[kernel]
    rows = {"fwd": 1, "dq": 2, "dkv": 2}[kernel]
    nbytes = 2.0 * tensors * B * H * S * D + 4.0 * rows * B * H * S
    t_ops, t_bytes = ops / bf16_peak, nbytes / bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_time_flash(torch, state):
    """Rows 9-11 at the LM's attention, bf16, causal: each kernel's device
    time per launch (CUDA events for the forward; the profiler, by name,
    for the two backward kernels, whose call also computes delta), also
    on the LM's [B, S, H, D] buffers seen transposed, the
    plain versions over the same batch (in slices of 2, so that their
    scores fit), and the library yardstick scaled_dot_product_attention
    (causal) forward and backward, timed here and never called by the
    port."""
    import torch.nn.functional as tF
    from mxnet_tpu_torch.kernels import flash_attention as FA

    card = state["card"]
    case = (LM_BATCH,) + FLASH_MAIN[1:]
    q, k, v, do = flash_case(torch, case, torch.bfloat16, seed=1200)
    scale = 128 ** -0.5
    o, lse = FA._flash_forward(q, k, v, True, scale)
    per = {"fwd": device_ms(torch, lambda: FA._flash_forward(
        q, k, v, True, scale), iters=20)}
    per.update(kernel_ms(torch, lambda: FA._flash_backward(
        q, k, v, o, lse, do, True, scale), 10,
        {"dq": ("flash_dq",), "dkv": ("flash_dkv",)}))
    bwd_call = device_ms(torch, lambda: FA._flash_backward(
        q, k, v, o, lse, do, True, scale), iters=10)

    def sliced(fn):
        def run():
            for i in range(0, LM_BATCH, 2):
                fn(i, i + 2)
        return run

    plain = {
        "fwd": sliced(lambda a, b: FA.flash_forward_reference(
            q[a:b], k[a:b], v[a:b], True, scale)),
        "dq": sliced(lambda a, b: FA.backward_dq_reference(
            q[a:b], k[a:b], v[a:b], o[a:b], lse[a * 32:b * 32], do[a:b],
            True, scale)),
        "dkv": sliced(lambda a, b: FA.backward_dkv_reference(
            q[a:b], k[a:b], v[a:b], o[a:b], lse[a * 32:b * 32], do[a:b],
            True, scale))}
    plain_ms = {n: device_ms(torch, fn, iters=2, warmup=1)
                for n, fn in plain.items()}
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_fwd = device_ms(torch, lambda: tF.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    out = tF.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters=10)
    res = {}
    for n in ("fwd", "dq", "dkv"):
        t_bound, by = flash_bound(n, card)
        res[n] = {"ms": per[n], "plain_ms": plain_ms[n],
                  "library_ms": lib_fwd if n == "fwd" else lib_bwd,
                  "bound_ms": t_bound * 1e3, "bound_by": by,
                  "roofline_share": roofline_share(
                      t_bound * 1e3, per[n], "flash_attention %s" % n),
                  "launches_per_step": FLASH_PER_STEP[n]}
    state["flash_timing"] = res
    emit({"phase": "time", "kernel": "flash_attention", "dtype": "bfloat16",
          "shape_bhsd": list(case[:5]), "causal": True, "per_launch": res,
          "backward_call_ms": bwd_call,
          "library": "F.scaled_dot_product_attention(is_causal=True): "
                     "forward for row 9; its backward (dq, dk and dv "
                     "together) for rows 10 and 11"})
    del q, k, v, do, o, lse, qg, kg, vg, out
    # the three bf16 kernels on the [B, S, H, D] buffers the LM passes,
    # seen transposed, beside the contiguous times above
    q, k, v, do = flash_case(torch, case, torch.bfloat16, seed=1200,
                             layout="bshd")
    o, lse = FA._flash_forward(q, k, v, True, scale)
    strided = {"fwd": device_ms(torch, lambda: FA._flash_forward(
        q, k, v, True, scale), iters=20)}
    strided.update(kernel_ms(torch, lambda: FA._flash_backward(
        q, k, v, o, lse, do, True, scale), 10,
        {"dq": ("flash_dq",), "dkv": ("flash_dkv",)}))
    emit({"phase": "time", "kernel": "flash_attention", "dtype": "bfloat16",
          "layout": "bshd", "shape_bhsd": list(case[:5]), "causal": True,
          "strides_q": list(q.stride()), "ms_per_launch": strided,
          "over_bhsd": {n: strided[n] / per[n] for n in strided}})
    del q, k, v, do, o, lse
    # the forward at head dim 64, the kernel's other width
    case = (LM_BATCH, FLASH_MAIN[1], LM_SEQ, LM_SEQ, 64, True)
    q, k, v, _ = flash_case(torch, case, torch.bfloat16, seed=1201)
    t_bound, by = flash_bound("fwd", card, D=64)
    ms = device_ms(torch, lambda: FA._flash_forward(q, k, v, True, 0.125),
                   iters=20)
    lib_ms = device_ms(torch, lambda: tF.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    emit({"phase": "time", "kernel": "flash_attention.fwd",
          "dtype": "bfloat16", "shape_bhsd": list(case[:5]), "causal": True,
          "ms_per_launch": ms, "bound_ms": t_bound * 1e3, "bound_by": by,
          "roofline_share": roofline_share(
              t_bound * 1e3, ms, "flash_attention fwd, head dim 64"),
          "library_ms": lib_ms})
    # the f32 forward (CUDA cores) at the LM's attention, batch cut to 1
    q, k, v, _ = flash_case(torch, FLASH_MAIN, torch.float32, seed=1202)
    ms = device_ms(torch, lambda: FA._flash_forward(q, k, v, True,
                                                     128 ** -0.5), iters=5)
    emit({"phase": "time", "kernel": "flash_attention.fwd",
          "dtype": "float32", "shape_bhsd": list(FLASH_MAIN[:5]),
          "causal": True, "ms_per_launch": ms})
    del q, k, v
    torch.cuda.empty_cache()


def phase_time_lm(torch, state):
    """The LM training step (phase train_lm) at batch 12: tokens/sec and
    wall ms from the host clock over 3 steps ending in a synchronize,
    device busy ms and idle share from the profiler over one step, the
    flash kernels' device ms per step, and model TFLOP/s = 6 * params *
    tokens / step time (bench.py's formula) with its share of the card's
    bf16 peak (``mfu``)."""
    step = state.get("train_lm")
    if step is None:
        return
    step()
    torch.cuda.synchronize()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    busy_ms, by_kernel, tops = profile_busy_ms(
        torch, step, 1, top=12,
        match=("flash_fwd", "flash_dq", "flash_dkv"))
    tokens = LM_BATCH * LM_SEQ
    tflops = 6.0 * state["lm_params"] * tokens / wall / 1e12
    peak = state["card"][1][0]
    res = {"tokens_per_sec": tokens / wall, "wall_ms_per_step": wall * 1e3,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": None if busy_ms is None
           else max(0.0, 1.0 - busy_ms / (wall * 1e3)),
           "model_tflops_per_sec": tflops, "mfu": tflops * 1e12 / peak,
           "peak_bf16_tflops": peak / 1e12, "params": state["lm_params"],
           "flash_kernel_ms_per_step_by_name": by_kernel}
    state["lm_timing"] = res
    emit({"phase": "time", "lm_train_step_bf16_b12_s2048": res})
    if tops:
        emit(dict({"phase": "time", "where_the_time_goes": "train_lm"},
                  **tops))


def _int8_split(torch, net, x):
    """Device ms of one int8 forward's own stages, each timed alone with
    CUDA events on the inputs its layers saw: the quantize passes (divide,
    round, clip, cast), the im2col, and the kernel; summed over the 54
    layers."""
    _, seen = _layer_inputs(net, lambda: net(x))
    split = {"quantize_ms": 0.0, "im2col_ms": 0.0, "kernel_ms": 0.0}
    for layer, xin in seen:
        split["quantize_ms"] += device_ms(
            torch, lambda: layer.quantize_input(xin), iters=5, warmup=1)
        xq = layer.quantize_input(xin)
        split["im2col_ms"] += device_ms(
            torch, lambda: layer.columns(xq), iters=5, warmup=1)
        cols = layer.columns(xq)[0]
        split["kernel_ms"] += device_ms(
            torch, lambda: layer.product(cols), iters=5, warmup=1)
        del xq, cols
    return split


def phase_time_qmm(torch, state):
    """Rows 12 and 13 at every distinct product shape of int8 ResNet-50 v1
    at batch 32 (read off the network; the op family's pass makes one
    int32 product at each), CUDA events: both forms of the kernel, their
    plain versions and the library yardstick torch._int_mm (cuBLASLt; for
    row 13 followed by a multiply by the scales, two calls), timed here and
    never called by the port, beside the bound, its share and the route
    the launches took. Then the totals per op-family pass (row 12) and per
    b32 forward (row 13). Needs no other phase but env, so that a parent
    tree can be timed with this script in turns."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import quantized_matmul as QM

    card = state["card"]
    shapes = _int8_shapes(torch, mx, state)
    counts = dict(shapes)
    for shape in state.get("int8_op_shapes", ()):
        counts.setdefault(shape, 0)
    per = {}
    for i, ((M, K, N), count) in enumerate(sorted(counts.items())):
        x, w, s = qmm_case(torch, M, K, N, 800 + i)
        row = {}
        for name, sc in (("mm", None), ("mm_scaled", s)):
            before = _qmm_counts(QM)
            row[name] = device_ms(torch, lambda: QM.quantized_matmul(
                x, w, sc), iters=20)
            row["route_" + name] = _qmm_route_of(QM, before, name)
        row["plain_mm"] = device_ms(
            torch, lambda: QM.quantized_matmul_reference(x, w), iters=3,
            warmup=1)
        row["plain_mm_scaled"] = device_ms(
            torch, lambda: QM.quantized_matmul_reference(x, w, s), iters=3,
            warmup=1)
        try:
            row["library_mm"] = device_ms(torch, lambda: torch._int_mm(x, w),
                                          iters=20)
            row["library_mm_scaled"] = device_ms(
                torch, lambda: torch._int_mm(x, w) * s, iters=20)
            row["library_refused"] = None
        except RuntimeError as e:
            row["library_mm"] = row["library_mm_scaled"] = None
            row["library_refused"] = str(e).splitlines()[0][:160]
        for name, scaled in (("mm", False), ("mm_scaled", True)):
            t_bound, by = qmm_bound(M, K, N, scaled, card)
            row["bound_" + name] = t_bound * 1e3
            row["bound_by_" + name] = by
            row["roofline_share_" + name] = roofline_share(
                t_bound * 1e3, row[name],
                "quantized_matmul %s %s" % (name, (M, K, N)))
        if hasattr(QM, "qmm_plan"):
            p = QM.qmm_plan(M, K, N, QM._sm_count(x.device))
            row["plan"] = {"bn": p.bn, "nsplit": p.nsplit, "items": p.items,
                           "grid": p.grid}
        per[(M, K, N)] = row
        emit({"phase": "time", "kernel": "quantized_matmul",
              "shape_mkn": [M, K, N], "launches_per_int8_forward_b32": count,
              **row})
        del x, w, s
    torch.cuda.empty_cache()

    def totals(calls, name):
        lib = [per[c]["library_" + name] for c in calls]
        bound = sum(per[c]["bound_" + name] for c in calls)
        ops_bound = sum(per[c]["bound_" + name] for c in calls
                        if per[c]["bound_by_" + name] == "operations")
        ms = sum(per[c][name] for c in calls)
        return {"ms": ms,
                "plain_ms": sum(per[c]["plain_" + name] for c in calls),
                "bound_ms": bound,
                "roofline_share": roofline_share(bound, ms,
                                                 "quantized_matmul " + name),
                "bound_by": "operations" if ops_bound >= bound / 2
                else "bytes",
                "library_ms": None if None in lib else sum(lib),
                "library_refused": sorted({per[c]["library_refused"]
                                           for c in calls} - {None}),
                "routes": sorted({str(per[c]["route_" + name])
                                  for c in calls})}

    forward = [c for c, n in shapes for _ in range(n)]
    op_family = state.get("int8_op_shapes") or [c for c, _ in shapes]
    state["qmm_timing"] = {"mm": totals(op_family, "mm"),
                           "mm_scaled": totals(forward, "mm_scaled")}
    emit({"phase": "time", "kernel": "quantized_matmul",
          "per_int8_forward_b32_mm_scaled": state["qmm_timing"]["mm_scaled"],
          "per_op_family_pass_mm": state["qmm_timing"]["mm"]})


def phase_time_int8(torch, state):
    """Rows 12 and 13 per shape (phase_time_qmm). Then the int8 forward at
    batch 32 and 256: images/sec (host clock), device busy ms and idle
    share (profiler), and device ms split into the kernels, the im2col,
    the quantize passes and the float layers (the rest); beside it the
    same network's float32 forward, with TF32 off and on."""
    phase_time_qmm(torch, state)

    # whole forward: int8, float32 (TF32 off), float32 (TF32 on)
    nets = state["int8"]
    rates = {}
    for label, model, tf32 in (("int8", nets["net"], False),
                               ("float32", nets["float_net"], False),
                               ("float32_tf32", nets["float_net"], True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        for batch, iters in ((32, 20), (256, 5)):
            x = torch.rand(batch, 3, 224, 224, device="cuda")
            for _ in range(3):
                model(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
            busy_ms, by_kernel, ops = profile_busy_ms(
                torch, lambda: model(x), 3,
                top=10 if batch == 32 else None, match=("qmm_",))
            res = {"images_per_sec": batch / wall * 1e3,
                   "wall_ms_per_forward": wall,
                   "device_busy_ms_per_forward": busy_ms,
                   "device_idle_share": None if busy_ms is None
                   else max(0.0, 1.0 - busy_ms / wall)}
            if label == "int8":
                split = _int8_split(torch, model, x)
                split["profiler_kernel_ms"] = None if by_kernel is None \
                    else by_kernel["qmm_"]
                if busy_ms is not None:
                    split["float_layers_ms"] = busy_ms - (
                        split["quantize_ms"] + split["im2col_ms"]
                        + split["kernel_ms"])
                res["device_ms_split"] = split
            rates["%s,b%d" % (label, batch)] = res
            if ops:
                emit({"phase": "time", "where_the_time_goes":
                      "resnet50_v1_nchw_%s,b%d" % (label, batch),
                      "top_ops": ops["top_ops"]})
            del x
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["int8_timing"] = rates
    emit({"phase": "time", "resnet50_v1_nchw_int8_vs_float32": rates})


def _self_device_us(ev):
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if us is None else us


PROFILE_TRIES = 3
# Late in a long run a profiler window drops device events of launches made
# near its start (5 of the first 10 launches a minute into a process, over
# 100 late in a full pass; chip_profile_probe.py --windows). So each window
# opens with PROFILE_PRIMER empty kernels and a synchronize, and fn's
# launches follow.
PROFILE_PRIMER = 256
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _profile(torch, fn, iters):
    """torch.profiler over `iters` calls of fn(): ({device kernel or copy
    name: device us}, [(device us of its kernels, host op name)]). The
    window opens with a primer of empty kernels; a launch of fn's with no
    device event in the window (found by correlation id: a launch after
    the primer's) means the window lost events, and then, as when a window
    saw no device event at all, it is profiled again with a primer four
    times as long, up to PROFILE_TRIES times; after that the dict stays
    empty, as for a window that saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    primer = PROFILE_PRIMER
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = prof.profiler.kineto_results.events()
        seen = {e.correlation_id() for e in evs
                if str(e.device_type()).endswith("CUDA")}
        calls = sorted((e.start_ns(), e.correlation_id()) for e in evs
                       if str(e.device_type()).endswith("CPU")
                       and e.name() in LAUNCH_CALLS)
        lost = sum(c not in seen for _, c in calls[primer:])
        kernels, by_op = {}, []
        for ev in prof.key_averages():
            us = _self_device_us(ev)
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                if us > 0:              # a host op, by its kernels' time
                    by_op.append((us, ev.key))
                continue
            if "spin_kernel" not in ev.key:     # not the primer's
                kernels[ev.key] = kernels.get(ev.key, 0.0) + us
        if any(us > 0 for us in kernels.values()) and not lost:
            return kernels, by_op
        print("chip_smoke: the profiler %s (try %d of %d, primer %d)"
              % ("lost %d of %d launches" % (lost, len(calls) - primer)
                 if lost else "saw no device event",
                 attempt + 1, PROFILE_TRIES, primer), file=sys.stderr)
        primer *= 4
    return {}, by_op


def kernel_ms(torch, fn, iters, groups):
    """Device ms per call of fn() in the kernels of each group ({label:
    name substrings}), from the profiler. Where the profiler saw no device
    time at all or lost events, a single group is timed with CUDA events
    instead
    (device_ms: the queued launches' span, so gaps between them count).
    Fails where the profiler saw device work but none in a group's
    kernels."""
    kernels, _ = _profile(torch, fn, iters)
    if not any(us > 0 for us in kernels.values()) and len(groups) == 1:
        print("chip_smoke: timing %s with CUDA events" % list(groups),
              file=sys.stderr)
        return {label: device_ms(torch, fn, iters) for label in groups}
    out = {}
    for label, names in groups.items():
        us = sum(v for k, v in kernels.items() if any(n in k for n in names))
        if us <= 0:
            raise AssertionError("the profiler saw no %s kernel (%s)"
                                 % (label, sorted(kernels)[:20]))
        out[label] = us / iters / 1e3
    return out


def device_busy_ms(torch, fn, iters):
    """Device time per call of fn(), summed over its kernels and copies
    (profiler): unlike device_ms, no host gap between launches counts.
    Where the profiler saw no device time or lost events, device_ms (CUDA
    events)."""
    kernels, _ = _profile(torch, fn, iters)
    us = sum(kernels.values())
    if us <= 0:
        print("chip_smoke: timing a call with CUDA events", file=sys.stderr)
        return device_ms(torch, fn, iters)
    return us / iters / 1e3


def host_ms(torch, fn, iters):
    """Wall time per call of fn() on the host clock, ending in a
    synchronize: what the caller waits for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def profile_busy_ms(torch, fn, iters, top=None, match=("conv_fused",)):
    """From torch.profiler: device time per call of fn() summed over its
    kernels, the part spent in kernels whose name contains each string of
    `match` ({string: ms}), and (with `top`) {"top_ops": the host ops whose
    kernels took the most device time, "top_kernels": the kernels that
    took the most}. (None, None, {}) where the profiler saw no device
    time or lost events."""
    kernels, by_op = _profile(torch, fn, iters)
    total = sum(kernels.values())
    fused = {m: sum(us for k, us in kernels.items() if m in k) / iters / 1e3
             for m in match}
    if total <= 0:
        return None, None, {}
    tops = {}
    if top:
        by_kernel = [(us, key) for key, us in kernels.items()]
        for name, rows in (("top_ops", by_op), ("top_kernels", by_kernel)):
            tops[name] = [{"op": key[:60], "ms_per_call": us / iters / 1e3,
                           "share": us / total}
                          for us, key in sorted(rows)[::-1][:top]]
    return total / iters / 1e3, fused, tops


# -- phases train_module and train_symblock (the symbolic and Module API) -----

# Module.fit on the NCHW ResNet-50 symbol: batch 128, f32, SGD momentum 0.9
# at lr 1e-3 (REC_SGD's: 0.01 diverges from this init on noise images),
# MODULE_EPOCHS epochs of the one batch; a checkpoint every
# MODULE_CKPT_PERIOD epochs.
MODULE_BATCH = 128
MODULE_EPOCHS = 8
MODULE_CKPT_PERIOD = 4
MODULE_SGD = dict(REC_SGD)
# The card-vs-CPU check of the first step's forward takes the batch's first
# MODULE_CPU_IMAGES images (training mode: batch statistics over them), f32
# with TF32 off on both sides, within MODULE_FWD_RTOL of the largest output.
MODULE_CPU_IMAGES = 8
MODULE_FWD_RTOL = 1e-4
# Predictor (symbol JSON + raw .params bytes) against Module.predict on the
# same PREDICT_BATCH images: absolute error of the softmax outputs.
PREDICT_BATCH = 32
PREDICT_ATOL = 1e-6
# train_symblock: SGD steps of the SymbolBlock (train's SGD), the first
# against the zoo net's own eager step within one bf16 rounding step of
# each tensor's largest value (RTOL["bfloat16"]).
SYMBLOCK_STEPS = 3


def _all_launch_counts():
    """{module.counter: value} of every kernel wrapper's launch counter."""
    import importlib
    out = {}
    for name in ("batchnorm_fused", "box_nms", "compression", "conv_fused",
                 "flash_attention", "optimizer_apply", "quantized_matmul"):
        mod = importlib.import_module("mxnet_tpu_torch.kernels." + name)
        for attr in dir(mod):
            if not attr.startswith("LAUNCHES"):
                continue
            v = getattr(mod, attr)
            if isinstance(v, dict):
                out.update({"%s.%s.%s" % (name, attr, k): n
                            for k, n in v.items()})
            else:
                out["%s.%s" % (name, attr)] = v
    return out


def _zero_all_launch_counts():
    import importlib
    for key in _all_launch_counts():
        parts = key.split(".")
        mod = importlib.import_module("mxnet_tpu_torch.kernels." + parts[0])
        if len(parts) == 3:
            getattr(mod, parts[1])[parts[2]] = 0
        else:
            setattr(mod, parts[1], 0)


def phase_train_module(torch, state):
    """The Module path of MXNet's classic train_imagenet on the port:
    resnet50_v1() (NCHW) traced with mx.sym.var("data") under a
    SoftmaxOutput, Module.fit on the card (the module docstring), the
    checkpoint loaded and scored, then served through Predictor. NCHW
    BatchNorm runs the plain deterministic tree (as the JAX package's
    does), so no kernel of the repository runs: every counter must read
    0."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    with mx.name.NameManager():
        sym = mx.sym.SoftmaxOutput(resnet50_v1()(mx.sym.var("data")),
                                   name="softmax")
    n_args = len(sym.list_arguments())
    n_aux = len(sym.list_auxiliary_states())
    x_np, y_np = _batch(state)
    ctx = mx.gpu(0)
    it = mx.io.NDArrayIter(x_np, y_np, batch_size=MODULE_BATCH)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    arg0, aux0 = mod.get_params()
    arg0 = {k: v.asnumpy() for k, v in arg0.items()}
    aux0 = {k: v.asnumpy() for k, v in aux0.items()}

    losses = []

    def record_loss(param):
        # the step's forward (before its update): -mean log p[label]
        p = mod.get_outputs()[0]._data
        lbl = param.locals["data_batch"].label[0]._data.long()
        pick = p.gather(1, lbl.view(-1, 1)).clamp_min(1e-30)
        losses.append(-pick.log().mean().item())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_module_")
    prefix = os.path.join(tmp, "resnet50_v1")
    try:
        torch.cuda.synchronize()
        _zero_all_launch_counts()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=MODULE_EPOCHS, kvstore="local",
                optimizer="sgd", optimizer_params=dict(MODULE_SGD),
                eval_metric="acc", batch_end_callback=record_loss,
                epoch_end_callback=mx.callback.do_checkpoint(
                    prefix, period=MODULE_CKPT_PERIOD))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_launch_counts()
        ok_counts = all(v == 0 for v in counts.values())
        ok_loss = len(losses) == MODULE_EPOCHS and \
            all(np.isfinite(losses)) and losses[-1] < losses[0]
        files = sorted(os.listdir(tmp))
        want_files = sorted(["resnet50_v1-symbol.json"] + [
            "resnet50_v1-%04d.params" % e
            for e in range(MODULE_CKPT_PERIOD, MODULE_EPOCHS + 1,
                           MODULE_CKPT_PERIOD)])

        # the first step's forward, card against CPU, from the initial
        # parameters on the batch's first images (f32, TF32 off)
        xs = x_np[:MODULE_CPU_IMAGES]
        ys = y_np[:MODULE_CPU_IMAGES]
        outs = []
        with mx.precision.matmul_precision("float32"):
            for c in (ctx, mx.cpu()):
                m = mx.mod.Module(sym, context=c)
                m.bind([("data", xs.shape)], [("softmax_label", ys.shape)])
                m.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in arg0.items()},
                             {k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in aux0.items()})
                m.forward(mx.io.DataBatch([mx.nd.array(xs, ctx=c)],
                                          [mx.nd.array(ys, ctx=c)]),
                          is_train=True)
                outs.append(m.get_outputs()[0].asnumpy())
        fwd_err = float(np.abs(outs[0] - outs[1]).max()
                        / np.abs(outs[1]).max())

        # the checkpoint: loaded, scored, and served through Predictor
        last = MODULE_EPOCHS
        sym2, arg2, aux2 = mx.model.load_checkpoint(prefix, last)
        ok_ckpt = (len(arg2), len(aux2)) == (n_args - 2, n_aux)
        mod2 = mx.mod.Module(sym2, context=ctx)
        mod2.bind(it.provide_data, it.provide_label, for_training=False)
        mod2.set_params(arg2, aux2)
        score = dict(mod2.score(it, "acc"))
        with open(prefix + "-symbol.json") as f:
            sym_json = f.read()
        with open(prefix + "-%04d.params" % last, "rb") as f:
            param_bytes = f.read()
        xp = x_np[:PREDICT_BATCH]
        with mx.precision.matmul_precision("float32"):
            pred = mx.Predictor(sym_json, param_bytes, dev_type=ctx,
                                input_shapes={"data": xp.shape})
            pred.set_input("data", xp)
            pred.forward()
            served = pred.get_output(0)
            predicted = mod2.predict(mx.io.NDArrayIter(
                xp, y_np[:PREDICT_BATCH], batch_size=PREDICT_BATCH)).asnumpy()
        pred_err = float(np.abs(served - predicted).max())
        ok_pred = served.shape == (PREDICT_BATCH, 1000) and \
            np.isfinite(served).all() and pred_err <= PREDICT_ATOL
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # device time of one Module step (forward, backward, update)
    batch = mx.io.DataBatch([mx.nd.array(x_np, ctx=ctx)],
                            [mx.nd.array(y_np, ctx=ctx)])

    def step():
        mod.forward_backward(batch)
        mod.update()
    dev_ms = device_busy_ms(torch, step, 3)
    host = host_ms(torch, step, 2)
    fwd_ok = fwd_err <= MODULE_FWD_RTOL
    emit({"phase": "train_module", "net": "resnet50_v1 NCHW symbol + "
          "SoftmaxOutput", "arguments": n_args, "aux_states": n_aux,
          "dtype": "float32", "batch": MODULE_BATCH,
          "steps": MODULE_EPOCHS, "losses": losses,
          "fit_wall_s": wall, "checkpoint_files": files,
          "score": score, "kernel_launches": sum(counts.values()),
          "kernel_launches_note": "0 wanted: NCHW BatchNorm runs the "
          "plain tree (as the JAX package's does), no kernel of the "
          "repository is on this path",
          "first_forward_card_vs_cpu_max_rel": fwd_err,
          "first_forward_images": MODULE_CPU_IMAGES,
          "first_forward_rtol": MODULE_FWD_RTOL,
          "predictor_vs_predict_max_abs": pred_err,
          "predictor_atol": PREDICT_ATOL, "predictor_batch": PREDICT_BATCH,
          "device_busy_ms_per_step": dev_ms, "wall_ms_per_step": host,
          "ok": ok_counts and ok_loss and fwd_ok and ok_pred and ok_ckpt
          and files == want_files})
    state["launches_module"] = sum(counts.values())
    state["module_ms"] = {"device_busy": dev_ms, "wall": host}
    if not ok_counts:
        raise AssertionError("train_module launched kernels: %s"
                             % {k: v for k, v in counts.items() if v})
    if not ok_loss:
        raise AssertionError("train_module loss not finite and falling: %s"
                             % losses)
    if files != want_files or not ok_ckpt:
        raise AssertionError("train_module checkpoints %s (args %d, aux %d)"
                             % (files, len(arg2), len(aux2)))
    if not fwd_ok:
        raise AssertionError("train_module first forward card vs CPU %.3g "
                             "over %g" % (fwd_err, MODULE_FWD_RTOL))
    if not ok_pred:
        raise AssertionError("Predictor against Module.predict: %.3g over "
                             "%g" % (pred_err, PREDICT_ATOL))


def phase_train_symblock(torch, state):
    """The deployment round trip, fine-tuned: train's net (resnet50_v1
    NHWC, numpy seed 0, bf16, fuse=False) traced and saved
    (Symbol.save), its parameters exported, SymbolBlock.imports on the
    card, cast to bf16 and trained with gluon.Trainer (train's SGD) under
    autograd.record on train's batch. Every BatchNorm is channels-last, so
    each of rows 4-7 launches BN_PER_STEP times per step (each fold its
    finalize launch too), conv_fused never. The first step against the
    zoo net's own eager step from the same parameters and batch."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    x_np, y_np = _batch(state)
    loss_fn = SoftmaxCrossEntropyLoss()
    ctx = mx.gpu(0)
    net = _build_net(mx, arrays, False, "bfloat16", ctx)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_symblock_")
    try:
        graph = os.path.join(tmp, "resnet50_v1-graph.json")
        with mx.name.NameManager():
            net(mx.sym.var("data")).save(graph)
        net.export(os.path.join(tmp, "resnet50_v1"))
        blk = mx.gluon.SymbolBlock.imports(
            graph, ["data"], os.path.join(tmp, "resnet50_v1-0000.params"),
            ctx=ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    blk.cast("bfloat16")
    ref = net.collect_params()
    got = blk.collect_params()
    if sorted(ref) != sorted(got):
        raise AssertionError("SymbolBlock parameters %d, the net's %d"
                             % (len(got), len(ref)))
    x = torch.from_numpy(x_np).to(ctx.device, torch.bfloat16)
    y = torch.from_numpy(y_np).to(ctx.device)
    ref_trainer = mx.gluon.Trainer(ref, "sgd", dict(SGD))
    trainer = mx.gluon.Trainer(got, "sgd", dict(SGD))

    # the first step against the zoo net's own eager step
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref_loss = _train_step(mx, net, ref_trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        _zero_counts(BNF, CF)
        losses = []
        per_step = []
        for i in range(SYMBLOCK_STEPS):
            before = _bn_counts(BNF)
            loss = _train_step(mx, blk, trainer, loss_fn, x, y)
            losses.append(loss.detach().float().mean().item())
            after = _bn_counts(BNF)
            per_step.append({k: after[k] - before[k]
                             for k in BN_KERNELS + ("finalize",)})
            if i == 0:
                first_loss = loss.detach().float()
                first = {n: got[n]._tensor().detach().float().clone()
                         for n in got}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    counts = _bn_counts(BNF)
    conv = CF.LAUNCHES
    want = {k: BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * BN_PER_STEP
    ok_counts = all(s == want for s in per_step) and conv == 0

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    loss_err = rel(first_loss, ref_loss.detach().float())
    param_err = max(rel(first[n], ref[n]._tensor().detach().float())
                    for n in ref)
    same_bits = torch.equal(first_loss, ref_loss.detach().float()) and all(
        torch.equal(first[n], ref[n]._tensor().detach().float())
        for n in ref)
    tol = RTOL["bfloat16"]
    ok_match = loss_err <= tol and param_err <= tol
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]

    # device ms per step: the SymbolBlock's and the zoo net's eager step
    # (phase train's), in turns
    sym_step = lambda: _train_step(mx, blk, trainer, loss_fn, x, y)  # noqa
    eager_step = lambda: _train_step(mx, net, ref_trainer, loss_fn, x,  # noqa
                                     y)
    ms = {"symblock": [], "eager": []}
    for name, fn in (("symblock", sym_step), ("eager", eager_step),
                     ("eager", eager_step), ("symblock", sym_step)):
        ms[name].append(device_busy_ms(torch, fn, 3))
    emit({"phase": "train_symblock", "net": "resnet50_v1 NHWC bf16 "
          "through Symbol.save, export and SymbolBlock.imports",
          "batch": len(x_np), "steps": SYMBLOCK_STEPS, "losses": losses,
          "launches_per_step": per_step, "launches_wanted_per_step": want,
          "conv_fused_launches": conv,
          "first_step_vs_zoo_eager_max_rel": {"loss": loss_err,
                                              "param": param_err},
          "first_step_same_bits": same_bits, "tolerance_rel": tol,
          "device_busy_ms_per_step": ms,
          "ok": ok_counts and ok_match and ok_loss})
    state["launches_symblock"] = {k: counts[k] for k in BN_KERNELS}
    state["launches_symblock"]["conv_fused"] = conv
    state["symblock_ms"] = ms
    if not ok_counts:
        raise AssertionError("SymbolBlock launches per step %s (conv_fused "
                             "%d), want %s" % (per_step, conv, want))
    if not ok_match:
        raise AssertionError("SymbolBlock first step against the zoo net: "
                             "loss %.3g, param %.3g over %g"
                             % (loss_err, param_err, tol))
    if not ok_loss:
        raise AssertionError("SymbolBlock loss not finite and falling: %s"
                             % losses)


def kernel_summary(state):
    """The {"kernels": [...]} entries: each kernel's launches on its path,
    its error against its plain version and its times beside its bound,
    from the state the phases filled."""
    t = state["timing"]

    def sharded(key):
        # launches over phase train_sharded's 5 timed steps, per
        # configuration
        return {cfg: n[key] for cfg, n in state["launches_sharded"].items()}
    kernels = [{
        "name": "conv_fused", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/conv_fused.cu",
        "replaces": "mxnet_tpu/pallas_kernels/conv_fused.py:121",
        "launches": state["launches"]["conv_fused"],
        "launches_train_sharded": sharded("conv_fused"),
        "launches_train_rec": state["launches_rec"]["conv_fused"],
        "launches_train_jpeg": state["launches_jpeg"]["conv_fused"],
        "launches_train_symblock": state["launches_symblock"]["conv_fused"],
        "max_abs_err": state["kernel_err"]["bfloat16"][0],
        "max_rel_err": state["kernel_err"]["bfloat16"][1],
        "tolerance_rel": RTOL["bfloat16"],
        "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "per": "one ResNet-50 forward at batch 32, bf16 (16 launches)",
        "design": CONV_FWD_DESIGN,
    }]
    for k in BN_KERNELS:
        b = state["bn_timing"][k]
        kernels.append({
            "name": "batchnorm_fused." + k, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/batchnorm_fused.cu",
            "replaces": "mxnet_tpu/pallas_kernels/batchnorm_fused.py:%d"
            % BN_REPLACES[k],
            "launches": state["launches"][k],
            "launches_train_sharded": sharded(k),
            "launches_zoo": state["launches_zoo"][k],
            "launches_train_amp": state["launches_amp"][k],
            "launches_train_rec": state["launches_rec"][k],
            "launches_train_jpeg": state["launches_jpeg"][k],
            "launches_train_symblock": state["launches_symblock"][k],
            "max_abs_err": state["bn_err"][k][0],
            "max_rel_err": state["bn_err"][k][1],
            "tolerance_rel": 0.0 if k in ("stats", "apply") else BN_BWD_RTOL,
            "ms": b["ms"], "kernel_ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": b["library_ms"],
            "design": BN_FOLD_DESIGN if k in ("stats", "bwd_reduce")
            else None,
            "per": "one ResNet-50 training step at batch 128, bf16 "
                   "(%d launches%s)" % (BN_PER_STEP, "" if k in (
                       "apply", "bwd_dx") else " and %d finalize "
                       "launches" % BN_PER_STEP),
        })
    for k, (_, _, body_line) in CONV_BWD.items():
        c = state["conv_bwd_timing"][k]
        kernels.append({
            "name": "conv_fused." + k, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/conv_fused.cu",
            "replaces": "mxnet_tpu/pallas_kernels/conv_fused.py:%d"
            % body_line,
            "launches": state["launches"]["conv_fused." + k],
            "launches_train_sharded": sharded("conv_fused." + k),
            "launches_train_rec": state["launches_rec"]["conv_fused." + k],
            "launches_train_jpeg": state["launches_jpeg"]["conv_fused." + k],
            "max_abs_err": state["conv_bwd_err"][k][0],
            "max_rel_err": state["conv_bwd_err"][k][1],
            "tolerance_rel": BWD_RTOL["bfloat16"]["dx"],
            "ms": c["ms"], "kernel_ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "per": "one fused ResNet-50 training step at batch 128, "
                   "bf16 (%d launches and %d %s launches)"
                   % (FUSED_PER_STEP, FUSED_PER_STEP,
                      "finalize" if k == "bwd_dx" else "reduce"),
            "design": CONV_BWD_DESIGN[k],
        })
    for k in ("fwd", "dq", "dkv"):
        f = state["flash_timing"][k]
        n = FLASH_PER_STEP[k]
        kernels.append({
            "name": "flash_attention." + k, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/pallas_kernels/flash_attention.py:%d"
            % FLASH_REPLACES[k],
            "launches": state["launches"]["flash_attention." + k],
            "launches_train_lm_deep": {
                cfg: n[k] for cfg, n in state["launches_lm_deep"].items()},
            "max_abs_err": state["flash_err"][k][0],
            "max_rel_err": state["flash_err"][k][1],
            "rel_err_per": "row: a query row of o and dq, a key row of dk "
                           "and dv, against the row's max |reference|",
            "tolerance_rel": FLASH_RTOL["bfloat16"]["o"],
            "ms": n * f["ms"], "kernel_ms": n * f["ms"],
            "plain_ms": n * f["plain_ms"], "bound_ms": n * f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": n * f["library_ms"],
            "per": "one transformer-LM training step, bf16, batch 12 x "
                   "2048, H 32, D 128, causal (%d launches)" % n,
            "design": FLASH_DESIGN[k],
        })
        if k != "fwd":
            # one SDPA backward computes dq, dk and dv: its time belongs to
            # the pair, not to each row
            kernels[-1]["library_covers"] = ["flash_attention.dq",
                                             "flash_attention.dkv"]
        if k == "dkv":
            kernels[-1]["library_shared_with"] = "flash_attention.dq"
    for k in ("mm", "mm_scaled"):
        q = state["qmm_timing"][k]
        n = state["launches"]["quantized_matmul." + k]
        kernels.append({
            "name": "quantized_matmul." + k, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/quantized_matmul.cu",
            "replaces": "mxnet_tpu/pallas_kernels/quantized_matmul.py:%d"
            % QMM_REPLACES[k],
            "launches": n,
            # the kernel phase failed unless every output matched bit for bit
            "max_abs_err": state["qmm_err"][k], "max_rel_err": 0.0,
            "tolerance_rel": 0.0,
            "ms": q["ms"], "kernel_ms": q["ms"], "plain_ms": q["plain_ms"],
            "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
            "library_ms": q["library_ms"],
            "library_note": "torch._int_mm (cuBLASLt)" + (
                " then a multiply by the scales: two calls"
                if k == "mm_scaled" else "")
            + ("; refused: %s" % q["library_refused"]
               if q["library_refused"] else ""),
            "design": QMM_DESIGN,
            "per": "one int8 ResNet-50 v1 forward at batch 32 (%d launches; "
                   "phase serve_int8 made %d forwards)"
                   % (INT8_LAYERS, n // INT8_LAYERS) if k == "mm_scaled"
            else "one pass of the nd.contrib quantized_conv and "
                 "quantized_fully_connected ops over int8 ResNet-50's "
                 "distinct layers at batch 32 (%d launches)" % n,
        })
    a = state["apply_timing"]
    kernels.append({
        "name": "optimizer_apply", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/optimizer_apply.cu",
        "replaces": "mxnet_tpu/pallas_kernels/optimizer_apply.py:80",
        "launches": state["launches"]["optimizer_apply"],
        "launches_zoo": state["launches_zoo"]["optimizer_apply"],
        # the phase failed unless the apply matched bit for bit
        "max_abs_err": state["apply_err"], "max_rel_err": 0.0,
        "tolerance_rel": 0.0,
        "ms": a["ms"], "kernel_ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None, "library_note": a["library_note"],
        "per_param_update_phase_ms": a["per_param_update_phase_ms"],
        "per_param_update_phase_host_ms":
            a["per_param_update_phase_host_ms"],
        "per": "one update phase of the fused ResNet-50 step, bf16 SGD "
               "momentum 0.9 (%d launches, one per bucket)"
               % state["apply_buckets"],
    })
    a = state["adam_timing"]
    kernels.append({
        "name": "optimizer_apply.adam", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/optimizer_apply.cu",
        "replaces": "mxnet_tpu/pallas_kernels/optimizer_apply.py:80",
        "launches": state["launches"]["optimizer_apply.adam"],
        # the phase failed unless the apply matched bit for bit
        "max_abs_err": state["adam_err"], "max_rel_err": 0.0,
        "tolerance_rel": 0.0,
        "ms": a["ms"], "kernel_ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": a["library_ms"], "library_note": a["library_note"],
        "per": "one update phase of the fused ResNet-50 step, bf16 Adam "
               "(%d launches, one per bucket)" % state["adam_buckets"],
    })
    for k in ("quantize", "dequantize"):
        c = state["codec_timing"][k]
        kernels.append({
            "name": "compression.%s_2bit" % k, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/compression.cu",
            "replaces": "mxnet_tpu/pallas_kernels/compression.py:%d"
            % CODEC_REPLACES[k],
            "launches": state["launches"]["compression." + k],
            # the kernel phase failed unless every output matched bit for bit
            "max_abs_err": state["codec_err"], "max_rel_err": 0.0,
            "tolerance_rel": 0.0,
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "library_note": c["library_note"],
            "segments": state["launches"]["compression.%s_segments" % k],
            "per": "one compressed-kvstore ResNet-50 step, bf16 (%d launch "
                   "of %d segments: the compressed gradients)"
                   % (c["launches_per_step"], c["segments_per_step"]),
        })
    n = state["nms_timing"]
    kernels.append({
        "name": "box_nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/box_nms.cu",
        "replaces": "mxnet_tpu/ops/extended.py:418 (a lax.scan, not a "
                    "Pallas kernel)",
        "launches": state["launches"]["box_nms"],
        # the phase failed unless the keep masks matched bit for bit
        "max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance_rel": 0.0,
        "ms": n["ms"], "kernel_ms": n["ms"], "plain_ms": n["plain_ms"],
        "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
        "library_ms": None,
        "library_note": "PyTorch has no NMS of its own (torchvision's is "
                        "not installed)",
        "kernel_ms_by_name": n["kernel_ms_by_name"],
        "per": "one MultiBoxDetection NMS at SSD300 scale: batch %d, %d "
               "sorted boxes, class-aware (one launch pair)"
               % (SSD300_BATCH, SSD300_ANCHORS),
    })
    # phase train_module (NCHW ResNet-50 through Module.fit) launches no
    # kernel of the repository: every counter read 0 there
    for k in kernels:
        k["launches_train_module"] = state["launches_module"]
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(SUB_PHASES)
    if unknown:
        ap.error("unknown phases %s" % sorted(unknown))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: run from a checkout of the repository (%s)" % e,
              file=sys.stderr)
        return 2

    line = smi()
    state = {"smi": line, "card": peaks(line.split(",")[0])}
    for p in PHASES + SUB_PHASES:
        if p in phases:
            globals()["phase_" + p](torch, state)

    print(line, flush=True)
    if all(p in phases for p in PHASES):
        emit({"kernels": kernel_summary(state)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
