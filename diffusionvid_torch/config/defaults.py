"""Default configuration tree of the PyTorch port.

The key names are those of the reference's yacs tree
(``mega_core/config/defaults.py`` plus the DiffusionDet additions), so the
experiment YAMLs under ``configs/`` load unmodified.  This copy holds the
branches the port reads; a YAML may add keys the defaults do not name
(``CfgNode.merge_from_other`` accepts new keys).  ``TPU.COMPUTE_DTYPE`` keeps
its name because the YAMLs set it: it is the activation dtype on any device.
"""

from .node import CfgNode


def get_default_cfg() -> CfgNode:
    _C = CfgNode()

    _C.MODEL = CfgNode()
    _C.MODEL.META_ARCHITECTURE = "DiffusionDet"
    _C.MODEL.DEVICE = "cuda"
    _C.MODEL.RPN_ONLY = False
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.RETINANET_ON = False
    _C.MODEL.WEIGHT = ""
    _C.MODEL.PIXEL_MEAN = (123.675, 116.280, 103.530)
    _C.MODEL.PIXEL_STD = (58.395, 57.120, 57.375)

    # the mask and keypoint ROI heads (reference defaults.py:240-270): of
    # these ``build_detection_model`` reads only ROI_KEYPOINT_HEAD.NUM_CLASSES, as the JAX
    # package's does; the heads keep their modules' defaults
    _C.MODEL.ROI_MASK_HEAD = CfgNode()
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 2
    _C.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (256, 256, 256, 256)
    _C.MODEL.ROI_MASK_HEAD.RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.DILATION = 1
    _C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS_THRESHOLD = 0.5
    _C.MODEL.ROI_KEYPOINT_HEAD = CfgNode()
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 2
    _C.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = tuple(512 for _ in range(8))
    _C.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES = 17

    # RetinaNet (reference defaults.py:307-362); NUM_CONVS and PRIOR_PROB
    # are not read, as in the JAX package (the head keeps 4 and 0.01)
    _C.MODEL.RETINANET = CfgNode()
    _C.MODEL.RETINANET.NUM_CLASSES = 81
    _C.MODEL.RETINANET.ANCHOR_SIZES = (32, 64, 128, 256, 512)
    _C.MODEL.RETINANET.ASPECT_RATIOS = (0.5, 1.0, 2.0)
    _C.MODEL.RETINANET.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
    _C.MODEL.RETINANET.OCTAVE = 2.0
    _C.MODEL.RETINANET.SCALES_PER_OCTAVE = 3
    _C.MODEL.RETINANET.NUM_CONVS = 4
    _C.MODEL.RETINANET.FG_IOU_THRESHOLD = 0.5
    _C.MODEL.RETINANET.BG_IOU_THRESHOLD = 0.4
    _C.MODEL.RETINANET.LOSS_ALPHA = 0.25
    _C.MODEL.RETINANET.LOSS_GAMMA = 2.0
    _C.MODEL.RETINANET.PRIOR_PROB = 0.01
    _C.MODEL.RETINANET.PRE_NMS_TOP_N = 1000
    _C.MODEL.RETINANET.INFERENCE_TH = 0.05
    _C.MODEL.RETINANET.NMS_TH = 0.4
    _C.MODEL.RETINANET.BBOX_REG_WEIGHT = 4.0
    _C.MODEL.RETINANET.BBOX_REG_BETA = 0.11

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.CONV_BODY = "R-101-torchvision"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 101
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = False
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.OUT_FEATURES = ("res2", "res3", "res4", "res5")

    _C.MODEL.SWIN = CfgNode()
    _C.MODEL.SWIN.SIZE = "B"
    _C.MODEL.SWIN.USE_CHECKPOINT = False
    _C.MODEL.SWIN.OUT_FEATURES = (0, 1, 2, 3)

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = ("res3", "res4", "res5")
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.ROI_HEADS = CfgNode()
    _C.MODEL.ROI_HEADS.IN_FEATURES = ("p3", "p4", "p5")
    _C.MODEL.ROI_BOX_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    _C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 31   # 30 VID classes + background

    # RPN of the C4 architectures (reference defaults.py:119-180)
    _C.MODEL.RPN = CfgNode()
    _C.MODEL.RPN.USE_FPN = False
    _C.MODEL.RPN.ANCHOR_SIZES = (64, 128, 256, 512)
    _C.MODEL.RPN.ANCHOR_STRIDE = (16,)
    _C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
    _C.MODEL.RPN.STRADDLE_THRESH = 0
    _C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
    _C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOP_N_TEST = 300
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.MIN_SIZE = 0

    # DiffusionDet head (reference add_diffusiondet_config)
    _C.MODEL.DiffusionDet = CfgNode()
    _C.MODEL.DiffusionDet.NUM_CLASSES = 30
    _C.MODEL.DiffusionDet.NUM_PROPOSALS = 300
    _C.MODEL.DiffusionDet.NHEADS = 8
    _C.MODEL.DiffusionDet.DROPOUT = 0.0
    _C.MODEL.DiffusionDet.DIM_FEEDFORWARD = 2048
    _C.MODEL.DiffusionDet.ACTIVATION = "relu"
    _C.MODEL.DiffusionDet.HIDDEN_DIM = 256
    _C.MODEL.DiffusionDet.NUM_CLS = 1
    _C.MODEL.DiffusionDet.NUM_REG = 3
    _C.MODEL.DiffusionDet.NUM_HEADS = 6
    _C.MODEL.DiffusionDet.NUM_HEADS_LOCAL = 0
    _C.MODEL.DiffusionDet.NUM_DYNAMIC = 2
    _C.MODEL.DiffusionDet.DIM_DYNAMIC = 64
    _C.MODEL.DiffusionDet.PRIOR_PROB = 0.01
    _C.MODEL.DiffusionDet.SNR_SCALE = 2.0
    _C.MODEL.DiffusionDet.SAMPLE_STEP = 1
    _C.MODEL.DiffusionDet.USE_NMS = True

    _C.MODEL.VID = CfgNode()
    _C.MODEL.VID.ENABLE = False
    _C.MODEL.VID.METHOD = "base"
    _C.MODEL.VID.ROI_BOX_HEAD = CfgNode()
    _C.MODEL.VID.ROI_BOX_HEAD.ATTENTION = CfgNode()
    _C.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE = False
    _C.MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE = 2
    _C.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ADVANCED_STAGE = 0
    _C.MODEL.VID.RPN = CfgNode()
    _C.MODEL.VID.RPN.REF_PRE_NMS_TOP_N = 6000
    _C.MODEL.VID.RPN.REF_POST_NMS_TOP_N = 75
    _C.MODEL.VID.RDN = CfgNode()
    _C.MODEL.VID.RDN.MIN_OFFSET = -18
    _C.MODEL.VID.RDN.MAX_OFFSET = 18
    _C.MODEL.VID.RDN.ALL_FRAME_INTERVAL = 37
    _C.MODEL.VID.RDN.KEY_FRAME_LOCATION = 18
    _C.MODEL.VID.RDN.REF_NUM = 2
    _C.MODEL.VID.RDN.RATIO = 0.2
    _C.MODEL.VID.FGFA = CfgNode()
    _C.MODEL.VID.FGFA.MIN_OFFSET = -9
    _C.MODEL.VID.FGFA.MAX_OFFSET = 9
    _C.MODEL.VID.FGFA.ALL_FRAME_INTERVAL = 19
    _C.MODEL.VID.FGFA.KEY_FRAME_LOCATION = 9
    _C.MODEL.VID.FGFA.REF_NUM = 2
    _C.MODEL.VID.DFF = CfgNode()
    _C.MODEL.VID.DFF.MIN_OFFSET = -9
    _C.MODEL.VID.DFF.MAX_OFFSET = 0
    _C.MODEL.VID.DFF.KEY_FRAME_DURATION = 10
    _C.MODEL.VID.MEGA = CfgNode()
    _C.MODEL.VID.MEGA.MIN_OFFSET = -12
    _C.MODEL.VID.MEGA.MAX_OFFSET = 12
    _C.MODEL.VID.MEGA.ALL_FRAME_INTERVAL = 25
    _C.MODEL.VID.MEGA.KEY_FRAME_LOCATION = 12
    _C.MODEL.VID.MEGA.SHUFFLED_CUR_TEST = False
    _C.MODEL.VID.MEGA.LOCAL = CfgNode()
    _C.MODEL.VID.MEGA.LOCAL.ENABLE = True
    _C.MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND = False
    _C.MODEL.VID.MEGA.MEMORY = CfgNode()
    _C.MODEL.VID.MEGA.MEMORY.ENABLE = False
    _C.MODEL.VID.MEGA.MEMORY.SIZE = 25
    _C.MODEL.VID.MEGA.GLOBAL = CfgNode()
    _C.MODEL.VID.MEGA.GLOBAL.ENABLE = True
    _C.MODEL.VID.MEGA.GLOBAL.RES_STAGE = 1
    _C.MODEL.VID.MEGA.GLOBAL.SIZE = 50
    _C.MODEL.VID.MEGA.GLOBAL.SHUFFLE = True
    _C.MODEL.VID.MEGA.GLOBAL.STOP_UPDATE_AFTER_INIT_TEST = True
    _C.MODEL.VID.MEGA.GLOBAL.PIXEL_ATTEND = False
    _C.MODEL.VID.MEGA.GLOBAL.PIXEL_STAGE = 0
    _C.MODEL.VID.MEGA.REF_NUM_GLOBAL = 4
    _C.MODEL.VID.MEGA.REF_NUM_LOCAL = 2
    _C.MODEL.VID.MEGA.REF_NUM_MEM = 3
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_METRIC = "distance"
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_TYPE = "greedy"
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST = 750
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TRAIN = 300
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TRAIN = 3000
    _C.MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TEST = 1000

    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = (600,)
    _C.INPUT.MAX_SIZE_TRAIN = 1000
    _C.INPUT.MIN_SIZE_TEST = 600
    _C.INPUT.MAX_SIZE_TEST = 1000
    _C.INPUT.PIXEL_MEAN = (123.675, 116.280, 103.530)
    _C.INPUT.PIXEL_STD = (58.395, 57.120, 57.375)
    _C.INPUT.TO_BGR255 = False
    _C.INPUT.INFER_BATCH = 1
    _C.INPUT.TRANSFORM = True          # the SSD augmentation of train samples

    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    _C.DATALOADER = CfgNode()
    _C.DATALOADER.SIZE_DIVISIBILITY = 32
    # train batches always hold one bucket (one sample a batch in the train
    # CLI, so grouping leaves the order as it is)
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True

    # what engine/train.py and tools/train_net.py read: the optimizer, its
    # schedule and the loop
    _C.SOLVER = CfgNode()
    _C.SOLVER.OPTIMIZER_TYPE = "adamw"
    _C.SOLVER.LR_SCHEDULER_TYPE = "step"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.0001
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.BACKBONE_MULTIPLIER = 0.1
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 3
    _C.SOLVER.WARMUP_ITERS = 500
    _C.SOLVER.CHECKPOINT_PERIOD = 2500
    _C.SOLVER.TEST_PERIOD = 2500       # iterations between validations (0: none)
    _C.SOLVER.IMS_PER_BATCH = 1        # the reference's images per optimizer step
    _C.SOLVER.ACCUMULATION_STEPS = 1
    _C.SOLVER.BATCH_REUSE_STEPS = 1    # iterations trained on one loaded batch
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0

    _C.TEST = CfgNode()
    _C.TEST.EXPECTED_RESULTS = ()
    _C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
    _C.TEST.DETECTIONS_PER_IMG = 300
    _C.TEST.SEQ_NMS = False
    # test-time box augmentation (reference defaults.py:552-565), base only
    _C.TEST.BBOX_AUG = CfgNode()
    _C.TEST.BBOX_AUG.ENABLED = False
    _C.TEST.BBOX_AUG.H_FLIP = True
    _C.TEST.BBOX_AUG.SCALES = ()
    _C.TEST.BBOX_AUG.MAX_SIZE = 4000
    _C.TEST.BBOX_AUG.SCALE_H_FLIP = False

    _C.TPU = CfgNode()
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.MAX_GT_BOXES = 64     # GT slots per frame of a train batch
    _C.TPU.MESH_DP = 1           # data-parallel size: the torchrun ranks, if set

    _C.OUTPUT_DIR = "."
    return _C
