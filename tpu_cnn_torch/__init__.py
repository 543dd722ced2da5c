"""tpu_cnn_torch — the PyTorch/CUDA port of ``tpu_cnn``, for NVIDIA Hopper.

The JAX package ``tpu_cnn`` stays the reference; this package runs the same
fixed-point contract (uint8 activations, int8 weights, conv3x3 -> >>shift ->
clip 0..255 -> 2x2 max pool) with plain PyTorch around hand-written CUDA
kernels (``csrc/``, built by ``ops._build``):

  - ``models.cnn``        — ``CNNConfig``, the numpy ``FpgaCNN`` holder and
                            ``TorchFpgaCNN`` (the int8 kernels, shifts and
                            head as buffers on an explicit device),
                            ``layer_weight_sizes``
  - ``models.registry``   — the named geometries (lyr3-std, lyr4-wide, ...)
                            and the region-head detectors (``DETECTORS``:
                            yolov2-tiny-voc, yolov3-416)
  - ``models.region``     — the region-head detectors' layer rows
                            ``(ic, oc, size, k, pool)``, ``RegionConfig``;
                            darknet layer graphs with [yolo] heads
                            (``DarknetConfig``, ``yolov3_rows``);
                            ``RegionModel`` (int8 kernels, int32 biases,
                            shifts a conv) and ``TorchRegionNet``
  - ``ops.quant``         — the contract in plain torch (the kernels'
                            reference and the CPU path), and
                            ``cnn_forward_chunked`` over sub-batches
  - ``ops.mega``          — the megakernel (``csrc/mega_cnn.cu``, on
                            ``csrc/hopper.cuh``), its weight packing
                            (wgmma B, the recast, the layer kernel's
                            fragments), shared-memory plan and the chained
                            plan
  - ``ops.conv_pool``     — the layer kernel (``csrc/conv_pool_layer.cu``)
  - ``ops.int8``          — the conv kernel (``csrc/conv_act.cu``) and the
                            ``pallas``/``hybrid`` forwards
  - ``ops.bitcast``       — the bitcast/roll probe's kernel
                            (``csrc/bitcast.cu``)
  - ``ops.detect_head``   — the device head: classifier, CAM boxes, the
                            multi-object and instance heads (label loops
                            exportable as ``while_loop``)
  - ``ops.cam_head``      — the single-box head with the "ref" box in one
                            kernel (``csrc/cam_head.cu``), on the
                            megakernel's bins and bf16 twin
  - ``ops.region_layer``  — the region route's layer kernel
                            (``csrc/region_layer.cu``: a region-head
                            detector's 3x3 convs of fewer than 128 input
                            channels, pooled, unpooled or stride 2, with a
                            residual; wgmma on channels-last maps)
  - ``ops.conv_stream``   — the weight-streaming layer kernel
                            (``csrc/conv_stream.cu``: wgmma on a ring of
                            bulk-copied weight slices; stride 2, residual,
                            upsample, maps inside a route's) and the plain
                            version of every region-head layer
  - ``ops.region_head``   — the region head (decode, per-class NMS, the
                            best pairs) in one kernel a batch
                            (``csrc/region_head.cu``) and its plain version
  - ``ops.yolo_head``     — the [yolo] heads (decode, thresholds, per-class
                            NMS over the three heads, the best pairs) in
                            one kernel a batch (``csrc/yolo_head.cu``) and
                            its plain version
  - ``reference.yolov2_tiny`` — the region-head detectors' plain reference
                            (torch alone, float64), whose layer functions
                            the plain version of every layer runs too;
                            the benchmark's copy adds its comparison
  - ``reference.yolov3``  — the darknet graphs' plain reference (the same,
                            with shortcuts, routes, upsamples, the [yolo]
                            heads)
  - ``ops.library``       — the megakernel and the layer kernel as the
                            ``torch.library`` ops ``tcnn::mega_cnn`` and
                            ``tcnn::conv_pool_layer`` (what an exported
                            program calls)
  - ``ops.preprocess``    — batched camera-frame preprocess in torch on
                            the frames' device (crop, BT.601 luma, resize)
  - ``ops.luma``          — the BT.601 constants, ``pack_bgrx``
  - ``engine.device``     — ``DeviceEngine``: the engines' device layer
                            (frames in, results out, spans, serving
                            protocol)
  - ``engine.cuda``       — ``CUDAEngine``: the FpgaCNN family's batched
                            fused detect; built on a region-head model it
                            returns a ``RegionEngine``
  - ``engine.region``     — ``RegionEngine``: the region-head detectors,
                            a chain or a darknet graph as a plan of conv
                            launches (``RegionResult``, ``region_routes``,
                            ``graph_route``, ``region_maps``)
  - ``engine.cpu_ref``    — the numpy oracle (``numpy_cnn_forward``) and
                            the host-oracle engine ``CPURefEngine``
  - ``native.oracle``     — the C++ oracle (``native/cnn_oracle.cpp``)
  - ``native.preprocess`` — the C++ batched frame preprocess (same source)
  - ``native.ring``       — the native frame ring (``native/frame_ring.cpp``);
                            the oracle, the preprocess, the ring and the
                            HTTP front (``native/http_front.cpp``) load
                            one host library, ``tcnn_host``
  - ``deploy``            — the deployable's loader ``DeployedDetector``
                            (imports no ``models``, ``engine`` or ``apps``)
  - ``head``              — the host numpy twins of the head (``cam``,
                            ``classify``, ``bbox`` with the ridge fit
                            ``fit_bbox_head``), the multi-object
                            detection filters (``detections``) and the
                            tracker
  - ``train.data``        — the numpy data generators: synthetic shapes,
                            composite and moving scenes (synthetic and
                            real photograph tiles), the folder and COCO
                            datasets, batching and augmentation
  - ``train.train_cnn``   — the two-phase QAT trainer: ``TrainNet`` (the
                            float net, ``F.conv2d`` with TF32 off), the
                            optimiser ``AdamCosine``, the plain, (data,
                            model) and ZeRO-1 train steps and the
                            dispatch to the pipe/space twins, phase 2 on
                            the contract's plain int32 version, the Adam
                            head fit ``fit_head``, export; its CLI (every
                            mesh and multi-host flag)
  - ``train.checkpoint``  — the ``.npz`` checkpoint (reads the JAX
                            trainer's too)
  - ``train.checkpoint_sharded`` — the sharded checkpoint directory
                            (``ShardedCheckpointer``: per-shard,
                            asynchronous, retention)
  - ``utils``             — the weights.bin, bundle and feature-dump
                            codecs, artifact paths, the completion wait
                            and the progress watchdog,
                            stage timers and the torch.profiler trace
                            context, the JSONL metrics sink and accuracy
                            reports (``metrics``), the export quantisers
                            and ``validate_stock_blob`` (``weights``), and
                            the card's peaks and
                            bounds (``roofline``)
  - ``parallel``          — the mesh axes: ``Mesh`` and ``MeshEngine``
                            (``mesh``: data and model axes, one CUDA
                            stream per position, the differentiable hop
                            ``Mesh.hop``), the GPipe ``pipeline`` and
                            ``pipeline_train``, the row-sharded
                            ``spatial`` and ``spatial_train``,
                            ``MultiHostEngine`` and ``global_batches``
                            over gloo (``multihost``), and ``dryrun``
                            (serving and training checks)
  - ``bench``             — the headline bench (``bench.py``'s measurement:
                            the gate, staged pools, the async-pipelined
                            loop ``measure``, one JSON line)
  - ``bench_gate``        — the bench's parity gate
  - ``graft_entry``       — ``__graft_entry__.py``: ``entry()`` (the
                            bench's production path on 8 frames) and its
                            ``__main__`` (with the mesh's dry runs)
  - ``ops._build``        — the kernels' and the host library's build
                            cache (``TPU_CNN_TORCH_BUILD_DIR`` and the
                            extra-flag variables isolate an instrumented
                            build) and ``path_counts``, the code paths
                            each kernel's launcher took
  - ``apps``              — ``infer`` (with ``make_engine``, the engine
                            swap: ``--mode auto|mega|pallas|hybrid|xla|
                            mesh|cpu``), ``serve`` (``--deployable`` too),
                            ``serve_native`` (the C++ HTTP front),
                            ``export_model`` (the ``.tcnnx`` deployable),
                            ``realtime`` (the camera app), ``verify`` and
                            ``probe_bitcast`` CLIs; the benchmark
                            (``benchmark``: throughput per mode, latency,
                            per-layer, roofline, camera pipeline, host
                            ingest, the train step); the offline tools
                            ``eval_detection``, ``eval_tracking``,
                            ``dump_features``, ``train_bbox`` and
                            ``doctor``; the head-fitting tools
                            ``retrain_classifier``, ``tune_shifts`` and
                            ``calibrate_multi``; ``kernel_cases`` (each
                            kernel against its plain version: phase 3 of
                            ``chip_smoke.py``) and the sanitizer lane
                            ``sanitize`` (ASan/TSan over ``tcnn_host``,
                            compute-sanitizer over the kernels); and their
                            ``common``

It imports ``torch`` and numpy, and nothing of ``tpu_cnn`` or ``jax``:
where it needs a JAX-free piece of the JAX package it keeps its own copy
(the tests hold each copy equal to its original).
"""

__version__ = "0.1.0"
