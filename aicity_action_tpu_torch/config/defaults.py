"""Default configuration tree (copy of ``aicity_action_tpu/config/defaults.py``).

Key-compatible with the reference framework's config surface
(`slowfast/config/defaults.py`) so that its YAML files —
e.g. `configs/Aicity/MVITV2_FULL_B_16x4_CONV_448.yaml` — load unchanged.
The device-count keys keep PyTorch's meaning in the port: one process a
card.

- ``NUM_GPUS``  → cards a host, one rank each
- ``NUM_SHARDS``→ hosts in the job (``SHARD_ID`` this one)
- ``DIST_BACKEND`` → the process group's backend: ``nccl`` on the card,
  ``gloo`` on the CPU or where named; ``INIT_METHOD`` its rendezvous

TPU-specific knobs live in the new ``TPU`` section; the PyTorch port keeps
the section so the same YAML files load, and reads ``TPU.COMPUTE_DTYPE``
as its compute type.
"""

from .node import CfgNode


def get_cfg() -> CfgNode:
    """Return a fresh default config (never share the tree between runs)."""
    _C = CfgNode()

    # ---------------------------------------------------------------- BN
    _C.BN = CfgNode()
    _C.BN.USE_PRECISE_STATS = False
    _C.BN.NUM_BATCHES_PRECISE = 200
    _C.BN.WEIGHT_DECAY = 0.0
    _C.BN.NORM_TYPE = "batchnorm"  # batchnorm | sub_batchnorm | sync_batchnorm
    _C.BN.NUM_SPLITS = 1
    _C.BN.NUM_SYNC_DEVICES = 1

    # ------------------------------------------------------------- TRAIN
    _C.TRAIN = CfgNode()
    _C.TRAIN.ENABLE = True
    _C.TRAIN.EVAL_FIRST = False
    _C.TRAIN.DATASET = "kinetics"
    _C.TRAIN.BATCH_SIZE = 64  # global batch size across all devices
    _C.TRAIN.EVAL_PERIOD = 10
    _C.TRAIN.CHECKPOINT_PERIOD = 10
    _C.TRAIN.AUTO_RESUME = True
    _C.TRAIN.CHECKPOINT_FILE_PATH = ""
    _C.TRAIN.CHECKPOINT_TYPE = "pytorch"  # pytorch (.pyth convert) | jax (orbax)
    _C.TRAIN.CHECKPOINT_INFLATE = False
    _C.TRAIN.CHECKPOINT_EPOCH_RESET = False
    _C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ()
    _C.TRAIN.MIXED_PRECISION = False  # bfloat16 activations on TPU
    _C.TRAIN.GATHER_BEFORE_LOSS = False
    _C.TRAIN.USE_MOCO = False
    _C.TRAIN.MOCO_MOMENTUM = 0.99

    # --------------------------------------------------------------- AUG
    _C.AUG = CfgNode()
    _C.AUG.ENABLE = False
    _C.AUG.NUM_SAMPLE = 1
    _C.AUG.COLOR_JITTER = 0.4
    _C.AUG.AA_TYPE = "rand-m9-mstd0.5-inc1"
    _C.AUG.INTERPOLATION = "bicubic"
    _C.AUG.RE_PROB = 0.25
    _C.AUG.RE_MODE = "pixel"
    _C.AUG.RE_COUNT = 1
    _C.AUG.RE_SPLIT = False

    # ------------------------------------------------------------- MIXUP
    _C.MIXUP = CfgNode()
    _C.MIXUP.ENABLE = False
    _C.MIXUP.ALPHA = 0.8
    _C.MIXUP.CUTMIX_ALPHA = 1.0
    _C.MIXUP.PROB = 1.0
    _C.MIXUP.SWITCH_PROB = 0.5
    _C.MIXUP.LABEL_SMOOTH_VALUE = 0.1

    # -------------------------------------------------------------- TEST
    _C.TEST = CfgNode()
    _C.TEST.ENABLE = True
    _C.TEST.DATASET = "kinetics"
    _C.TEST.BATCH_SIZE = 8
    _C.TEST.CHECKPOINT_FILE_PATH = ""
    _C.TEST.NUM_ENSEMBLE_VIEWS = 10
    _C.TEST.NUM_SPATIAL_CROPS = 3
    _C.TEST.CHECKPOINT_TYPE = "pytorch"
    _C.TEST.SAVE_RESULTS_PATH = ""
    _C.TEST.NO_LOG_CONFIG = False
    _C.TEST.ENABLE_SAVE = False

    # ------------------------------------------------------------ RESNET
    _C.RESNET = CfgNode()
    _C.RESNET.TRANS_FUNC = "bottleneck_transform"
    _C.RESNET.NUM_GROUPS = 1
    _C.RESNET.WIDTH_PER_GROUP = 64
    _C.RESNET.INPLACE_RELU = True
    _C.RESNET.STRIDE_1X1 = False
    _C.RESNET.ZERO_INIT_FINAL_BN = False
    _C.RESNET.DEPTH = 50
    _C.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
    _C.RESNET.SPATIAL_STRIDES = [[1], [2], [2], [2]]
    _C.RESNET.SPATIAL_DILATIONS = [[1], [1], [1], [1]]

    # --------------------------------------------------------------- X3D
    _C.X3D = CfgNode()
    _C.X3D.WIDTH_FACTOR = 1.0
    _C.X3D.DEPTH_FACTOR = 1.0
    _C.X3D.BOTTLENECK_FACTOR = 1.0
    _C.X3D.DIM_C5 = 2048
    _C.X3D.DIM_C1 = 12
    _C.X3D.SCALE_RES2 = False
    _C.X3D.BN_LIN5 = False
    _C.X3D.CHANNELWISE_3x3x3 = True

    # ---------------------------------------------------------- NONLOCAL
    _C.NONLOCAL = CfgNode()
    _C.NONLOCAL.LOCATION = [[[]], [[]], [[]], [[]]]
    _C.NONLOCAL.GROUP = [[1], [1], [1], [1]]
    _C.NONLOCAL.INSTANTIATION = "dot_product"
    _C.NONLOCAL.POOL = [
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
    ]

    # ------------------------------------------------------------- MODEL
    _C.MODEL = CfgNode()
    _C.MODEL.ARCH = "slowfast"
    _C.MODEL.MODEL_NAME = "SlowFast"
    _C.MODEL.NUM_CLASSES = 400
    _C.MODEL.LOSS_FUNC = "cross_entropy"
    _C.MODEL.SINGLE_PATHWAY_ARCH = ["2d", "c2d", "i3d", "slow", "x3d", "mvit"]
    _C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
    _C.MODEL.DROPOUT_RATE = 0.5
    _C.MODEL.DROPCONNECT_RATE = 0.0
    _C.MODEL.FC_INIT_STD = 0.01
    _C.MODEL.HEAD_ACT = "softmax"
    _C.MODEL.USE_HEAD_ACT_IN_TRAIN = False
    _C.MODEL.ACT_CHECKPOINT = False  # jax.checkpoint (remat) per block
    _C.MODEL.USE_MULTI_HEAD = False
    _C.MODEL.MULTI_DATASETS = ["kinetics", "mmit", "activitynet"]
    _C.MODEL.MULTI_REPLICAS = [1, 1, 1]
    _C.MODEL.MULTI_LOSS_FUNCS = [
        "soft_cross_entropy", "bce_logit", "soft_cross_entropy",
    ]
    _C.MODEL.MULTI_NUM_CLASSES = [700, 292, 200]
    _C.MODEL.MULTI_HEAD_ACT = ["softmax", "sigmoid", "softmax"]
    _C.MODEL.MULTI_LOSS_WEIGHTS = [1.0, 10.0, 1.0]
    _C.MODEL.MULTI_USE_MLP = False
    _C.MODEL.MULTI_PATH_TO_DATA_DIR = []
    _C.MODEL.MULTI_PATH_PREFIX = []
    _C.MODEL.MULTI_ADD_CROSS_PROJ = False
    _C.MODEL.MULTI_CROSS_PROJ_ADD_TO_PRED = False
    _C.MODEL.MULTI_PROJ_LOSS_FUNC = "soft_cross_entropy"
    _C.MODEL.MULTI_PROJ_LOSS_WEIGHT = 1.0
    _C.MODEL.MULTI_PROJ_SPARSITY_LOSS_TYPE = ""
    _C.MODEL.MULTI_PROJ_SPARSITY_WEIGHT = 1e-4
    _C.MODEL.LOAD_MULTI_PROJ_INIT_FILE = ""
    _C.MODEL.MULTI_FIX_PROJ = False
    _C.MODEL.MULTI_PROJ_TRAIN_DIFF_LR = False
    _C.MODEL.MULTI_PROJ_LR = 0.00001
    _C.MODEL.MULTI_PROJ_MOMENTUM = 0.1
    _C.MODEL.USE_VICREG_LOSS = False
    _C.MODEL.VICREG_LOSS_WEIGHT = 0.01
    _C.MODEL.MULTI_USE_MOCO = False
    _C.MODEL.MULTI_MOCO_MOMENTUM = 0.9
    _C.MODEL.LOAD_VISUAL = True

    # -------------------------------------------------------------- MVIT
    _C.MVIT = CfgNode()
    _C.MVIT.MODE = "conv"  # conv | avg | max pooling for q/k/v
    _C.MVIT.POOL_FIRST = False
    _C.MVIT.CLS_EMBED_ON = True
    _C.MVIT.PATCH_KERNEL = [3, 7, 7]
    _C.MVIT.PATCH_STRIDE = [2, 4, 4]
    _C.MVIT.PATCH_PADDING = [2, 4, 4]
    _C.MVIT.PATCH_2D = False
    _C.MVIT.EMBED_DIM = 96
    _C.MVIT.NUM_HEADS = 1
    _C.MVIT.MLP_RATIO = 4.0
    _C.MVIT.QKV_BIAS = True
    _C.MVIT.DROPPATH_RATE = 0.1
    _C.MVIT.DEPTH = 16
    _C.MVIT.NORM = "layernorm"
    _C.MVIT.DIM_MUL = []
    _C.MVIT.HEAD_MUL = []
    _C.MVIT.POOL_KV_STRIDE = None
    _C.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
    _C.MVIT.POOL_Q_STRIDE = []
    _C.MVIT.POOL_KVQ_KERNEL = None
    _C.MVIT.ZERO_DECAY_POS_CLS = True
    _C.MVIT.NORM_STEM = False
    _C.MVIT.SEP_POS_EMBED = False
    _C.MVIT.DROPOUT_RATE = 0.0
    _C.MVIT.DIRECT_INPUT = False
    # MViT-v2 flags (reference: defaults.py:489-492)
    _C.MVIT.Q_POOL_RESIDUAL = False
    _C.MVIT.Q_POOL_ALL = False
    _C.MVIT.CHANNEL_EXPAND_FRONT = False
    _C.MVIT.POOL_SKIP_USE_CONV = False
    _C.MVIT.NO_NORM_BEFORE_AVG = False

    # Mixture-of-Experts MLPs (beyond-reference; models/moe.py +
    # parallel/ep.py expert parallelism). Disabled by default — every
    # reference config is MoE-free.
    _C.MVIT.MOE = CfgNode()
    _C.MVIT.MOE.ENABLE = False
    _C.MVIT.MOE.NUM_EXPERTS = 8
    _C.MVIT.MOE.TOP_K = 2
    _C.MVIT.MOE.CAPACITY_FACTOR = 1.25
    # block indices whose MLP is an expert bank; [] = every other block
    _C.MVIT.MOE.LAYERS = []
    # weight on the Switch load-balance auxiliary loss in the train step
    _C.MVIT.MOE.AUX_LOSS_WEIGHT = 0.01

    # ---------------------------------------------------------- SLOWFAST
    _C.SLOWFAST = CfgNode()
    _C.SLOWFAST.BETA_INV = 8
    _C.SLOWFAST.ALPHA = 8
    _C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
    _C.SLOWFAST.FUSION_KERNEL_SZ = 5

    # -------------------------------------------------------------- DATA
    _C.DATA = CfgNode()
    _C.DATA.PATH_TO_DATA_DIR = ""
    _C.DATA.PATH_LABEL_SEPARATOR = " "
    _C.DATA.PATH_PREFIX = ""
    _C.DATA.NUM_FRAMES = 8
    _C.DATA.SAMPLING_RATE = 8
    _C.DATA.UNIFORM_SAMPLE_FRAME = False
    _C.DATA.TRAIN_PCA_EIGVAL = [0.225, 0.224, 0.229]
    _C.DATA.TRAIN_PCA_EIGVEC = [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ]
    _C.DATA.PATH_TO_PRELOAD_IMDB = ""
    _C.DATA.MEAN = [0.45, 0.45, 0.45]
    _C.DATA.INPUT_CHANNEL_NUM = [3, 3]
    _C.DATA.STD = [0.225, 0.225, 0.225]
    _C.DATA.TRAIN_JITTER_SCALES = [256, 320]
    _C.DATA.TRAIN_JITTER_SCALES_RELATIVE = []
    _C.DATA.TRAIN_JITTER_ASPECT_RELATIVE = []
    _C.DATA.USE_OFFSET_SAMPLING = False
    _C.DATA.TRAIN_JITTER_MOTION_SHIFT = False
    _C.DATA.TRAIN_CROP_SIZE = 224
    _C.DATA.TEST_CROP_SIZE = 256
    _C.DATA.TARGET_FPS = 30
    _C.DATA.DECODING_BACKEND = "cv2"  # cv2 (always available) | pyav | decord
    _C.DATA.DECODING_BACKEND_GPU_ENABLE = False
    _C.DATA.INV_UNIFORM_SAMPLE = False
    _C.DATA.RANDOM_FLIP = True
    _C.DATA.MULTI_LABEL = False
    _C.DATA.ENSEMBLE_METHOD = "sum"  # sum | max over views of one video
    _C.DATA.REVERSE_INPUT_CHANNEL = False
    _C.DATA.VAL_SKIP = 1
    _C.DATA.TEST_SKIP = 1
    _C.DATA.MODEL_DIFF_DATA = False
    _C.DATA.NUM_CLASSES = 1

    # ------------------------------------------------------------ CONTRA
    _C.CONTRA = CfgNode()
    _C.CONTRA.ENABLE = False
    _C.CONTRA.CONTEXT_LENGTH = 77
    _C.CONTRA.vocab_size = 49408
    _C.CONTRA.transformer_width = 512
    _C.CONTRA.transformer_layers = 12
    _C.CONTRA.transformer_heads = 8
    _C.CONTRA.use_MLP = False
    _C.CONTRA.embed_dim = 512

    # ------------------------------------------------------------ SOLVER
    _C.SOLVER = CfgNode()
    _C.SOLVER.BASE_LR = 0.1
    _C.SOLVER.LR_POLICY = "cosine"
    _C.SOLVER.COSINE_END_LR = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEP_SIZE = 1
    _C.SOLVER.STEPS = []
    _C.SOLVER.LRS = []
    _C.SOLVER.MAX_EPOCH = 300
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.DAMPENING = 0.0
    _C.SOLVER.NESTEROV = True
    _C.SOLVER.WEIGHT_DECAY = 1e-4
    _C.SOLVER.WARMUP_FACTOR = 0.1
    _C.SOLVER.WARMUP_EPOCHS = 0.0
    _C.SOLVER.WARMUP_START_LR = 0.01
    _C.SOLVER.OPTIMIZING_METHOD = "sgd"
    _C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False
    _C.SOLVER.COSINE_AFTER_WARMUP = False
    _C.SOLVER.ZERO_WD_1D_PARAM = False
    _C.SOLVER.CLIP_GRAD_VAL = None
    _C.SOLVER.CLIP_GRAD_L2NORM = None

    # ---------------------------------------------------------- top-level
    _C.NUM_GPUS = 1  # number of local accelerator chips (TPU cores per host)
    _C.NUM_SHARDS = 1  # number of hosts
    _C.SHARD_ID = 0
    _C.OUTPUT_DIR = "./tmp"
    _C.RNG_SEED = 1
    _C.LOG_PERIOD = 100
    _C.USE_TQDM = True
    _C.LOG_MODEL_INFO = True
    _C.LOG_CFG = True
    _C.DIST_BACKEND = "nccl"  # nccl (the card) | gloo (CPU, or named)
    _C.INIT_METHOD = "tcp://localhost:9999"  # the group's rendezvous

    # --------------------------------------------------------------- TPU
    # TPU-native knobs (new in this framework).
    _C.TPU = CfgNode()
    _C.TPU.MESH_SHAPE = []  # e.g. [8] or [2, 4]; empty = all devices on axis "data"
    _C.TPU.MESH_AXES = ["data"]
    _C.TPU.COMPUTE_DTYPE = "float32"  # float32 | bfloat16
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.PREFETCH_DEPTH = 2  # device prefetch depth of the input pipeline
    # ship train/eval input frames host->device as bf16 when
    # COMPUTE_DTYPE is bfloat16: the model's first op casts f32 inputs to
    # bf16 anyway (round-to-nearest-even, same as the host ml_dtypes
    # cast), so pre-casting is bit-identical and halves the H2D bytes —
    # the dominant input cost on PCIe, and 2x on tunneled links
    _C.TPU.BF16_HOST_TRANSFER = True
    _C.TPU.DONATE_STATE = True  # donate train state buffers under jit
    # overlap the orbax checkpoint write with the next epoch (the
    # device->host snapshot stays synchronous; loads/scans drain first)
    _C.TPU.ASYNC_CHECKPOINT = False
    # write a jax.profiler trace of train steps [PROFILE_START_STEP,
    # PROFILE_START_STEP + PROFILE_NUM_STEPS) to this directory ("" = off)
    _C.TPU.PROFILE_DIR = ""
    _C.TPU.PROFILE_START_STEP = 3  # skip compile + warmup steps
    _C.TPU.PROFILE_NUM_STEPS = 2

    # --------------------------------------------------------- BENCHMARK
    _C.BENCHMARK = CfgNode()
    _C.BENCHMARK.NUM_EPOCHS = 5
    _C.BENCHMARK.LOG_PERIOD = 100
    _C.BENCHMARK.SHUFFLE = True

    # ------------------------------------------------------- DATA_LOADER
    _C.DATA_LOADER = CfgNode()
    _C.DATA_LOADER.NUM_WORKERS = 8
    _C.DATA_LOADER.PIN_MEMORY = True
    _C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False

    # --------------------------------------------------------- DETECTION
    _C.DETECTION = CfgNode()
    _C.DETECTION.ENABLE = False
    _C.DETECTION.ALIGNED = True
    _C.DETECTION.SPATIAL_SCALE_FACTOR = 16
    _C.DETECTION.ROI_XFORM_RESOLUTION = 7
    _C.DETECTION.USE_CUBE_PROP = False
    _C.DETECTION.USE_SPATIAL_MAXPOOL_BEFORE_PROJ = False

    # --------------------------------------------------------------- AVA
    _C.AVA = CfgNode()
    _C.AVA.FRAME_DIR = ""
    _C.AVA.VIDEO_PATH = ""
    _C.AVA.LOAD_FROM_VIDEO = False
    _C.AVA.FRAME_LIST_DIR = ""
    _C.AVA.ANNOTATION_DIR = ""
    _C.AVA.TRAIN_LISTS = ["train.csv"]
    _C.AVA.TEST_LISTS = ["val.csv"]
    _C.AVA.TRAIN_GT_BOX_LISTS = ["ava_train_v2.2.csv"]
    _C.AVA.TRAIN_PREDICT_BOX_LISTS = []
    _C.AVA.ADD_KINETICS = False
    _C.AVA.IS_TEST_ON_KINETICS = False
    _C.AVA.KINETICS_VIDEO_FRAME_COUNT = "avakinetics.frame_count.csv"
    _C.AVA.TEST_PREDICT_BOX_LISTS = ["ava_val_predicted_boxes.csv"]
    _C.AVA.DETECTION_SCORE_THRESH = 0.9
    _C.AVA.BGR = False
    _C.AVA.TRAIN_USE_COLOR_AUGMENTATION = False
    _C.AVA.TRAIN_PCA_JITTER_ONLY = True
    _C.AVA.TEST_FORCE_FLIP = False
    _C.AVA.FULL_TEST_ON_VAL = False
    _C.AVA.LABEL_MAP_FILE = "ava_action_list_v2.2.pbtxt"
    _C.AVA.EXCLUSION_FILE = "ava_val_excluded_timestamps_v2.2.csv"
    _C.AVA.GROUNDTRUTH_FILE = "ava_val_v2.2.csv"
    _C.AVA.IMG_PROC_BACKEND = "cv2"
    _C.AVA.USE_LABEL_SMOOTHING = False
    _C.AVA.LABEL_SMOOTHING_EPS = 0.1

    # --------------------------------------------------------- MULTIGRID
    _C.MULTIGRID = CfgNode()
    _C.MULTIGRID.EPOCH_FACTOR = 1.5
    _C.MULTIGRID.SHORT_CYCLE = False
    _C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.5 ** 0.5]
    _C.MULTIGRID.LONG_CYCLE = False
    _C.MULTIGRID.LONG_CYCLE_FACTORS = [
        (0.25, 0.5 ** 0.5),
        (0.5, 0.5 ** 0.5),
        (0.5, 1),
        (1, 1),
    ]
    _C.MULTIGRID.BN_BASE_SIZE = 8
    _C.MULTIGRID.EVAL_FREQ = 3
    _C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
    _C.MULTIGRID.DEFAULT_B = 0
    _C.MULTIGRID.DEFAULT_T = 0
    _C.MULTIGRID.DEFAULT_S = 0

    # ------------------------------------------------------- TENSORBOARD
    _C.TENSORBOARD = CfgNode()
    _C.TENSORBOARD.ENABLE = False
    _C.TENSORBOARD.PREDICTIONS_PATH = ""
    _C.TENSORBOARD.LOG_DIR = ""
    _C.TENSORBOARD.CLASS_NAMES_PATH = ""
    _C.TENSORBOARD.CATEGORIES_PATH = ""
    _C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
    _C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
    _C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
    _C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""
    _C.TENSORBOARD.HISTOGRAM = CfgNode()
    _C.TENSORBOARD.HISTOGRAM.ENABLE = False
    _C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
    _C.TENSORBOARD.HISTOGRAM.TOPK = 10
    _C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]

    return _C


def assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Validate the config and infer derived values.

    Mirrors the reference's `assert_and_infer_cfg`
    (`slowfast/config/defaults.py:1139-1164`):
    batch divisibility, BN/resnet sanity, and optional LR scaling by the
    number of hosts.
    """
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        assert cfg.BN.NUM_SPLITS >= 1

    assert cfg.TRAIN.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0, (
        f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} not divisible by "
        f"NUM_GPUS={cfg.NUM_GPUS}"
    )
    assert cfg.TEST.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0, (
        f"TEST.BATCH_SIZE={cfg.TEST.BATCH_SIZE} not divisible by "
        f"NUM_GPUS={cfg.NUM_GPUS}"
    )
    # one rank a card: each rank takes global / (NUM_SHARDS * NUM_GPUS)
    world = max(cfg.NUM_SHARDS, 1) * max(cfg.NUM_GPUS, 1)
    for key in ("TRAIN", "TEST"):
        if cfg[key].BATCH_SIZE % world:
            raise ValueError(
                f"{key}.BATCH_SIZE={cfg[key].BATCH_SIZE} is not divisible by "
                f"the {world} ranks of NUM_SHARDS={cfg.NUM_SHARDS} x "
                f"NUM_GPUS={cfg.NUM_GPUS}")

    assert cfg.RESNET.NUM_GROUPS > 0
    assert cfg.RESNET.WIDTH_PER_GROUP > 0
    assert cfg.RESNET.WIDTH_PER_GROUP % cfg.RESNET.NUM_GROUPS == 0

    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.WARMUP_START_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.COSINE_END_LR *= cfg.NUM_SHARDS

    # the reference's AMP flag maps onto bf16 activations on TPU
    if cfg.TRAIN.MIXED_PRECISION and cfg.TPU.COMPUTE_DTYPE == "float32":
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"

    assert cfg.TPU.COMPUTE_DTYPE in ("float32", "bfloat16")
    assert cfg.TPU.PARAM_DTYPE in ("float32", "bfloat16")
    return cfg


# The settings of configs/AICITY_MVITV2_B_16x4_448.yaml, in code: the serving
# host may have no PyYAML, and tests hold this table equal to the YAML file.
_MVITV2_B_16x4_448 = {
    "TRAIN": {
        "ENABLE": True, "DATASET": "aicity", "BATCH_SIZE": 64,
        "EVAL_PERIOD": 10, "CHECKPOINT_PERIOD": 10, "AUTO_RESUME": True,
        "CHECKPOINT_TYPE": "pytorch",
    },
    "DATA": {
        "DECODING_BACKEND": "cv2", "NUM_FRAMES": 16, "SAMPLING_RATE": 4,
        "TRAIN_JITTER_SCALES": [480, 540], "TRAIN_CROP_SIZE": 448,
        "TEST_CROP_SIZE": 448, "INPUT_CHANNEL_NUM": [3],
        "TRAIN_JITTER_SCALES_RELATIVE": [0.08, 1.0],
        "TRAIN_JITTER_ASPECT_RELATIVE": [0.75, 1.3333], "RANDOM_FLIP": False,
    },
    "MVIT": {
        "ZERO_DECAY_POS_CLS": False, "SEP_POS_EMBED": True, "DEPTH": 16,
        "NUM_HEADS": 1, "EMBED_DIM": 96, "PATCH_KERNEL": (3, 7, 7),
        "PATCH_STRIDE": (2, 4, 4), "PATCH_PADDING": (1, 3, 3),
        "MLP_RATIO": 4.0, "QKV_BIAS": True, "DROPPATH_RATE": 0.4,
        "NORM": "layernorm", "MODE": "conv", "CLS_EMBED_ON": False,
        "DIM_MUL": [[1, 2.0], [3, 2.0], [14, 2.0]],
        "HEAD_MUL": [[1, 2.0], [3, 2.0], [14, 2.0]],
        "POOL_KVQ_KERNEL": [3, 3, 3], "POOL_KV_STRIDE_ADAPTIVE": [1, 8, 8],
        "POOL_Q_STRIDE": [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]],
        "DROPOUT_RATE": 0.0, "CHANNEL_EXPAND_FRONT": True,
        "Q_POOL_ALL": True, "Q_POOL_RESIDUAL": True,
    },
    "MODEL": {
        "NUM_CLASSES": 18, "ARCH": "mvit", "MODEL_NAME": "MViT",
        "LOSS_FUNC": "soft_cross_entropy", "DROPOUT_RATE": 0.5,
        "ACT_CHECKPOINT": True,
    },
    "SOLVER": {
        "ZERO_WD_1D_PARAM": True, "CLIP_GRAD_L2NORM": 1.0, "BASE_LR": 0.002,
        "COSINE_AFTER_WARMUP": True, "COSINE_END_LR": 0.00002,
        "WARMUP_START_LR": 0.00002, "WARMUP_EPOCHS": 15.0,
        "LR_POLICY": "cosine", "MAX_EPOCH": 100, "WEIGHT_DECAY": 1e-4,
        "OPTIMIZING_METHOD": "adamw",
    },
    "TEST": {
        "ENABLE": True, "DATASET": "aicity", "BATCH_SIZE": 64,
        "NUM_ENSEMBLE_VIEWS": 10, "NUM_SPATIAL_CROPS": 1,
    },
    "TPU": {"COMPUTE_DTYPE": "bfloat16"},
    "DATA_LOADER": {"NUM_WORKERS": 8},
    "NUM_GPUS": 8,
    "NUM_SHARDS": 1,
    "RNG_SEED": 0,
}


def mvitv2_b_16x4_448_cfg() -> CfgNode:
    """MViT-v2-B 16x4 @ 448, the AI City Track 3 model
    (``configs/AICITY_MVITV2_B_16x4_448.yaml``), built without reading YAML."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(_MVITV2_B_16x4_448))
    return cfg


# The MViT-v2-L trunk (PySlowFast configs/Kinetics/MVITv2_L_40x3_test.yaml;
# Li et al., MViTv2, CVPR 2022): the widths and depth that set the kernels'
# shapes (head dim 72, 144-1152 channels). Every other key stays the AI
# City recipe's.
MVITV2_L_TRUNK = {
    "EMBED_DIM": 144, "NUM_HEADS": 2, "DEPTH": 48,
    "DIM_MUL": [[2, 2.0], [8, 2.0], [44, 2.0]],
    "HEAD_MUL": [[2, 2.0], [8, 2.0], [44, 2.0]],
    "POOL_Q_STRIDE": [[2, 1, 2, 2], [8, 1, 2, 2], [44, 1, 2, 2]],
}


def mvitv2_l_16x4_448_cfg() -> CfgNode:
    """The AI City model with the MViT-v2-L trunk: ``EMBED_DIM`` 144,
    ``NUM_HEADS`` 2, ``DEPTH`` 48, the channels, heads and query stride
    doubling at blocks 2, 8 and 44 (PySlowFast
    ``configs/Kinetics/MVITv2_L_40x3_test.yaml``, whose ``POOL_Q_STRIDE``
    lists every block: its stride-1 entries are what ``Q_POOL_ALL`` gives
    here). The rest is the AI City recipe of
    :func:`mvitv2_b_16x4_448_cfg`: 16 frames every 4 at a 448 crop, no cls
    token, ``Q_POOL_ALL``, ``Q_POOL_RESIDUAL``, ``CHANNEL_EXPAND_FRONT``,
    18 classes, bf16. Not taken from the L config: its 40x3 sampling at a
    312 crop (the recipe's clips are 16x4 @448) and its relative position
    tables (``REL_POS_SPATIAL`` / ``REL_POS_TEMPORAL``), which neither
    package implements; its absolute position embedding is off
    (``USE_ABS_POS False``), where this model keeps the recipe's separable
    one. No L weights exist for this recipe: weights come from a seed."""
    cfg = mvitv2_b_16x4_448_cfg()
    for key, value in MVITV2_L_TRUNK.items():
        setattr(cfg.MVIT, key, value)
    return cfg


def mvitv2_b_16x4_448_moe_cfg() -> CfgNode:
    """The AI City model with ``MVIT.MOE.ENABLE`` at the section's defaults:
    every other block (1, 3, ..., 15) a bank of 8 experts, top-2, capacity
    factor 1.25, the load-balance loss at weight 0.01."""
    cfg = mvitv2_b_16x4_448_cfg()
    cfg.MVIT.MOE.ENABLE = True
    return cfg


# PySlowFast's published Kinetics-400 MViT-B 16x4
# (facebookresearch/SlowFast configs/Kinetics/MVIT_B_16x4_CONV.yaml; Fan et
# al., Multiscale Vision Transformers, ICCV 2021): the MViT-v1 with a cls
# token. Its MVIT section is the 448 table's without the three v2 lines
# (CHANNEL_EXPAND_FRONT, Q_POOL_ALL and Q_POOL_RESIDUAL stay at their
# defaults, False), with the cls token on and DropPath 0.2, at a 224 crop.
_MVIT_B_16x4_224 = {
    "TRAIN": {"ENABLE": True, "DATASET": "kinetics", "BATCH_SIZE": 64},
    "DATA": {
        "NUM_FRAMES": 16, "SAMPLING_RATE": 4,
        "TRAIN_JITTER_SCALES": [256, 320], "TRAIN_CROP_SIZE": 224,
        "TEST_CROP_SIZE": 224, "INPUT_CHANNEL_NUM": [3],
        "TRAIN_JITTER_SCALES_RELATIVE": [0.08, 1.0],
        "TRAIN_JITTER_ASPECT_RELATIVE": [0.75, 1.3333],
    },
    "MVIT": {
        "ZERO_DECAY_POS_CLS": False, "SEP_POS_EMBED": True, "DEPTH": 16,
        "NUM_HEADS": 1, "EMBED_DIM": 96, "PATCH_KERNEL": (3, 7, 7),
        "PATCH_STRIDE": (2, 4, 4), "PATCH_PADDING": (1, 3, 3),
        "MLP_RATIO": 4.0, "QKV_BIAS": True, "DROPPATH_RATE": 0.2,
        "NORM": "layernorm", "MODE": "conv", "CLS_EMBED_ON": True,
        "DIM_MUL": [[1, 2.0], [3, 2.0], [14, 2.0]],
        "HEAD_MUL": [[1, 2.0], [3, 2.0], [14, 2.0]],
        "POOL_KVQ_KERNEL": [3, 3, 3], "POOL_KV_STRIDE_ADAPTIVE": [1, 8, 8],
        "POOL_Q_STRIDE": [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]],
        "DROPOUT_RATE": 0.0, "CHANNEL_EXPAND_FRONT": False,
        "Q_POOL_ALL": False, "Q_POOL_RESIDUAL": False,
    },
    "MIXUP": {"ENABLE": True, "ALPHA": 0.8, "CUTMIX_ALPHA": 1.0,
              "PROB": 1.0, "SWITCH_PROB": 0.5, "LABEL_SMOOTH_VALUE": 0.1},
    "MODEL": {
        "NUM_CLASSES": 400, "ARCH": "mvit", "MODEL_NAME": "MViT",
        "LOSS_FUNC": "soft_cross_entropy", "DROPOUT_RATE": 0.5,
        "ACT_CHECKPOINT": False,
    },
    "SOLVER": {
        "ZERO_WD_1D_PARAM": True, "CLIP_GRAD_L2NORM": 1.0, "BASE_LR": 0.0001,
        "COSINE_AFTER_WARMUP": True, "COSINE_END_LR": 1e-6,
        "WARMUP_START_LR": 1e-6, "WARMUP_EPOCHS": 30.0,
        "LR_POLICY": "cosine", "MAX_EPOCH": 200, "MOMENTUM": 0.9,
        "WEIGHT_DECAY": 0.05, "OPTIMIZING_METHOD": "adamw",
    },
    "TEST": {"ENABLE": True, "DATASET": "kinetics", "BATCH_SIZE": 64,
             "NUM_SPATIAL_CROPS": 1, "NUM_ENSEMBLE_VIEWS": 5},
    "TPU": {"COMPUTE_DTYPE": "bfloat16"},
    "NUM_GPUS": 8,
    "NUM_SHARDS": 1,
    "RNG_SEED": 0,
}


def mvit_b_16x4_224_cfg() -> CfgNode:
    """MViT-B 16x4 @ 224 with a cls token (PySlowFast's Kinetics-400
    ``MVIT_B_16x4_CONV.yaml``), built in code; bf16, no activation
    checkpointing."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(_MVIT_B_16x4_224))
    return cfg


# PySlowFast's published Kinetics-400 SlowFast R50 8x8 (facebookresearch/
# SlowFast configs/Kinetics/SLOWFAST_8x8_R50.yaml); see the factory.
_SLOWFAST_8x8_R50 = {
    "TRAIN": {"ENABLE": True, "DATASET": "kinetics", "BATCH_SIZE": 64,
              "EVAL_PERIOD": 10, "CHECKPOINT_PERIOD": 1,
              "AUTO_RESUME": True},
    "DATA": {"NUM_FRAMES": 32, "SAMPLING_RATE": 2,
             "TRAIN_JITTER_SCALES": [256, 320], "TRAIN_CROP_SIZE": 224,
             "TEST_CROP_SIZE": 256, "INPUT_CHANNEL_NUM": [3, 3]},
    "SLOWFAST": {"ALPHA": 4, "BETA_INV": 8, "FUSION_CONV_CHANNEL_RATIO": 2,
                 "FUSION_KERNEL_SZ": 7},
    "RESNET": {
        "ZERO_INIT_FINAL_BN": True, "WIDTH_PER_GROUP": 64, "NUM_GROUPS": 1,
        "DEPTH": 50, "TRANS_FUNC": "bottleneck_transform",
        "STRIDE_1X1": False,
        "NUM_BLOCK_TEMP_KERNEL": [[3, 3], [4, 4], [6, 6], [3, 3]],
        "SPATIAL_STRIDES": [[1, 1], [2, 2], [2, 2], [2, 2]],
        "SPATIAL_DILATIONS": [[1, 1], [1, 1], [1, 1], [1, 1]],
    },
    "NONLOCAL": {"LOCATION": [[[], []], [[], []], [[], []], [[], []]],
                 "GROUP": [[1, 1], [1, 1], [1, 1], [1, 1]],
                 "INSTANTIATION": "dot_product"},
    "BN": {"USE_PRECISE_STATS": True, "NUM_BATCHES_PRECISE": 200},
    "SOLVER": {"BASE_LR": 0.1, "LR_POLICY": "cosine", "MAX_EPOCH": 196,
               "MOMENTUM": 0.9, "WEIGHT_DECAY": 1e-4, "WARMUP_EPOCHS": 34.0,
               "WARMUP_START_LR": 0.01, "OPTIMIZING_METHOD": "sgd"},
    "MODEL": {"NUM_CLASSES": 400, "ARCH": "slowfast",
              "MODEL_NAME": "SlowFast", "LOSS_FUNC": "cross_entropy",
              "DROPOUT_RATE": 0.5},
    "TEST": {"ENABLE": True, "DATASET": "kinetics", "BATCH_SIZE": 64},
    "DATA_LOADER": {"NUM_WORKERS": 8},
    "TPU": {"COMPUTE_DTYPE": "bfloat16"},
    "NUM_GPUS": 8,
    "NUM_SHARDS": 1,
    "RNG_SEED": 0,
}


def slowfast_8x8_r50_cfg() -> CfgNode:
    """SlowFast R50 8x8 (PySlowFast's Kinetics-400
    ``SLOWFAST_8x8_R50.yaml``; Feichtenhofer et al., SlowFast Networks for
    Video Recognition, ICCV 2019), built in code; bf16 activations as the
    port's other configs. The global batch of 64 is eight cards'.

    Against the JAX package's defaults it sets NUM_FRAMES 32 (default 8),
    SAMPLING_RATE 2 (8), SLOWFAST.ALPHA 4 (8), FUSION_KERNEL_SZ 7 (5),
    ZERO_INIT_FINAL_BN True (False), the two-pathway NUM_BLOCK_TEMP_KERNEL
    / SPATIAL_STRIDES / SPATIAL_DILATIONS / NONLOCAL lists, precise BN on
    (200 batches), the SGD solver (BASE_LR 0.1, cosine over 196 epochs, 34
    warm-up epochs from 0.01) and bf16; BETA_INV 8,
    FUSION_CONV_CHANNEL_RATIO 2, DEPTH 50, WIDTH_PER_GROUP 64, crop 224
    (test crop 256), 400 classes and the dot-product non-local setting
    equal the defaults."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(_SLOWFAST_8x8_R50))
    return cfg


def mvitv2_b_16x4_448_det_cfg() -> CfgNode:
    """MViT-v2-B 16x4 @ 448 with the RoI head: the AI City model as the
    reference's detection-checkpoint path serves it (whole-frame boxes,
    scripts/module_wrapper.py:558-576). ``mvitv2_b_16x4_448_cfg()`` with
    DETECTION.ENABLE True, DETECTION.ALIGNED True, ROI_XFORM_RESOLUTION 7,
    SPATIAL_SCALE_FACTOR 32 (the stride of the final 8x14x14 map at 448; the
    default 16 would put a whole-frame box past the map), MODEL.HEAD_ACT
    sigmoid and MODEL.LOSS_FUNC bce (the detection step applies its loss to
    the head's probabilities)."""
    cfg = mvitv2_b_16x4_448_cfg()
    cfg.DETECTION.ENABLE = True
    cfg.DETECTION.ALIGNED = True
    cfg.DETECTION.ROI_XFORM_RESOLUTION = 7
    cfg.DETECTION.SPATIAL_SCALE_FACTOR = 32
    cfg.MODEL.HEAD_ACT = "sigmoid"
    cfg.MODEL.LOSS_FUNC = "bce"
    return cfg


# PySlowFast's AVA v2.2 SlowFast R50 32x2 (facebookresearch/SlowFast
# configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml); see the factory.
_SLOWFAST_32x2_R50_AVA = {
    "TRAIN": {"DATASET": "ava", "EVAL_PERIOD": 5},
    "DATA": {"TEST_CROP_SIZE": 224},
    "DETECTION": {"ENABLE": True, "ALIGNED": True,
                  "ROI_XFORM_RESOLUTION": 7, "SPATIAL_SCALE_FACTOR": 16},
    "AVA": {
        "DETECTION_SCORE_THRESH": 0.8,
        "TRAIN_PREDICT_BOX_LISTS": [
            "ava_train_v2.2.csv",
            "person_box_67091280_iou90/ava_detection_train_boxes_and_"
            "labels_include_negative_v2.2.csv"],
        "TEST_PREDICT_BOX_LISTS": [
            "person_box_67091280_iou90/ava_detection_val_boxes_and_"
            "labels.csv"],
    },
    "RESNET": {"SPATIAL_STRIDES": [[1, 1], [2, 2], [2, 2], [1, 1]],
               "SPATIAL_DILATIONS": [[1, 1], [1, 1], [1, 1], [2, 2]]},
    "BN": {"USE_PRECISE_STATS": False},
    "SOLVER": {"LR_POLICY": "steps_with_relative_lrs",
               "STEPS": [0, 10, 15, 20], "LRS": [1, 0.1, 0.01, 0.001],
               "MAX_EPOCH": 20, "WEIGHT_DECAY": 1e-7, "WARMUP_EPOCHS": 5.0,
               "WARMUP_START_LR": 0.000125},
    "MODEL": {"NUM_CLASSES": 80, "LOSS_FUNC": "bce", "HEAD_ACT": "sigmoid"},
    "TEST": {"DATASET": "ava", "BATCH_SIZE": 8},
    "DATA_LOADER": {"NUM_WORKERS": 2},
}


def slowfast_32x2_r50_ava_cfg() -> CfgNode:
    """SlowFast R50 32x2 on AVA v2.2 (PySlowFast's
    ``configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml``; Feichtenhofer et al.,
    SlowFast Networks for Video Recognition, ICCV 2019), built in code on
    ``slowfast_8x8_r50_cfg()``: 32 frames at sampling rate 2, alpha 4, beta
    1/8, fusion ratio 2 with kernel 7, crop 224, jitter 256-320, SGD,
    momentum 0.9 and dropout 0.5 as there.

    Against ``slowfast_8x8_r50_cfg()`` it sets TRAIN.DATASET and
    TEST.DATASET ava (kinetics), TRAIN.EVAL_PERIOD 5 (10),
    DATA.TEST_CROP_SIZE 224 (256), DETECTION.ENABLE True with the aligned
    RoIAlign at resolution 7 and SPATIAL_SCALE_FACTOR 16,
    AVA.DETECTION_SCORE_THRESH 0.8 (0.9) and its predicted-box lists,
    RESNET.SPATIAL_STRIDES ``[[1, 1], [2, 2], [2, 2], [1, 1]]`` and
    SPATIAL_DILATIONS ``[[1, 1], [1, 1], [1, 1], [2, 2]]`` (res5 at stride
    1 and dilation 2: a stride-16, 14x14 map at 224), BN.USE_PRECISE_STATS
    False (True), SOLVER.LR_POLICY steps_with_relative_lrs (cosine) with
    STEPS ``[0, 10, 15, 20]`` and LRS ``[1, 0.1, 0.01, 0.001]``,
    MAX_EPOCH 20 (196), WEIGHT_DECAY 1e-7 (1e-4), WARMUP_EPOCHS 5 (34),
    WARMUP_START_LR 0.000125 (0.01), MODEL.NUM_CLASSES 80 (400),
    LOSS_FUNC bce (cross_entropy), HEAD_ACT sigmoid (softmax),
    TEST.BATCH_SIZE 8 (64) and DATA_LOADER.NUM_WORKERS 2 (8)."""
    cfg = slowfast_8x8_r50_cfg()
    cfg.merge_from_other_cfg(CfgNode(_SLOWFAST_32x2_R50_AVA))
    return cfg


def actionclip_mvitv2_b_16x4_448_cfg() -> CfgNode:
    """ActionCLIP at full width: the AI City MViT-v2-B 16x4 @ 448
    (``mvitv2_b_16x4_448_cfg()``) as the video tower, with MODEL.MODEL_NAME
    ActionCLIP and CONTRA.ENABLE True, so that its head is the contrastive
    projection (LN, then a bias-free linear map to CONTRA.embed_dim); the
    text tower keeps the CONTRA defaults, CLIP's ViT-B text encoder
    (Radford et al., Learning Transferable Visual Models From Natural
    Language Supervision, ICML 2021): width 512, 12 layers, 8 heads,
    context 77, vocabulary 49408, embedding 512, no MLP projection. The
    data is ``Web_video_text`` (captions as BPE ids in
    ``{split}_tokenized.csv``) for training and test."""
    cfg = mvitv2_b_16x4_448_cfg()
    cfg.MODEL.MODEL_NAME = "ActionCLIP"
    cfg.CONTRA.ENABLE = True
    cfg.TRAIN.DATASET = "web_video_text"
    cfg.TEST.DATASET = "web_video_text"
    return cfg
