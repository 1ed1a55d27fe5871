"""Defender facade: counterpart of ``fedml_tpu/core/security/fedml_defender.py``
(reference core/security/fedml_defender.py:40). A process-wide singleton
configured from ``args`` (``enable_defense``, ``defense_type``) by
``fedml_tpu_torch.init``; it routes the server's three hooks to the
defense. The table holds the JAX package's 22 entries."""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

DEFENSE_KRUM = "krum"
DEFENSE_MULTI_KRUM = "multi_krum"
DEFENSE_COORDINATE_MEDIAN = "coordinate_wise_median"
DEFENSE_TRIMMED_MEAN = "coordinate_wise_trimmed_mean"
DEFENSE_RFA = "rfa"
DEFENSE_GEO_MEDIAN = "geometric_median"
DEFENSE_NORM_DIFF_CLIPPING = "norm_diff_clipping"
DEFENSE_WEAK_DP = "weak_dp"
DEFENSE_FOOLSGOLD = "foolsgold"
DEFENSE_THREE_SIGMA = "3sigma"
DEFENSE_SLSGD = "slsgd"
DEFENSE_CRFL = "crfl"
DEFENSE_BULYAN = "bulyan"
DEFENSE_CCLIP = "cclip"
DEFENSE_CROSS_ROUND = "cross_round"
DEFENSE_OUTLIER_DETECTION = "outlier_detection"
DEFENSE_RESIDUAL_REWEIGHT = "residual_reweight"
DEFENSE_ROBUST_LEARNING_RATE = "robust_learning_rate"
DEFENSE_SOTERIA = "soteria"
DEFENSE_WBC = "wbc"
DEFENSE_THREE_SIGMA_FOOLSGOLD = "3sigma_foolsgold"
DEFENSE_THREE_SIGMA_GEOMEDIAN = "3sigma_geomedian"


def defense_table() -> dict:
    """``defense_type`` -> defense class."""
    from .defense.advanced import (BulyanDefense, CClipDefense, CrossRoundDefense,
                                   OutlierDetection, ResidualBasedReweightingDefense,
                                   RobustLearningRateDefense, SoteriaDefense,
                                   ThreeSigmaFoolsGoldDefense, ThreeSigmaGeoMedianDefense,
                                   WbcDefense)
    from .defense.robust_aggregation import (CoordinateWiseMedianDefense,
                                             CoordinateWiseTrimmedMeanDefense,
                                             GeometricMedianDefense, KrumDefense, RFADefense)
    from .defense.screening import (CRFLDefense, FoolsGoldDefense, NormDiffClippingDefense,
                                    SLSGDDefense, ThreeSigmaDefense, WeakDPDefense)

    return {
        DEFENSE_KRUM: KrumDefense,
        DEFENSE_MULTI_KRUM: KrumDefense,
        DEFENSE_COORDINATE_MEDIAN: CoordinateWiseMedianDefense,
        DEFENSE_TRIMMED_MEAN: CoordinateWiseTrimmedMeanDefense,
        DEFENSE_RFA: RFADefense,
        DEFENSE_GEO_MEDIAN: GeometricMedianDefense,
        DEFENSE_NORM_DIFF_CLIPPING: NormDiffClippingDefense,
        DEFENSE_WEAK_DP: WeakDPDefense,
        DEFENSE_FOOLSGOLD: FoolsGoldDefense,
        DEFENSE_THREE_SIGMA: ThreeSigmaDefense,
        DEFENSE_SLSGD: SLSGDDefense,
        DEFENSE_CRFL: CRFLDefense,
        DEFENSE_BULYAN: BulyanDefense,
        DEFENSE_CCLIP: CClipDefense,
        DEFENSE_CROSS_ROUND: CrossRoundDefense,
        DEFENSE_OUTLIER_DETECTION: OutlierDetection,
        DEFENSE_RESIDUAL_REWEIGHT: ResidualBasedReweightingDefense,
        DEFENSE_ROBUST_LEARNING_RATE: RobustLearningRateDefense,
        DEFENSE_SOTERIA: SoteriaDefense,
        DEFENSE_WBC: WbcDefense,
        DEFENSE_THREE_SIGMA_FOOLSGOLD: ThreeSigmaFoolsGoldDefense,
        DEFENSE_THREE_SIGMA_GEOMEDIAN: ThreeSigmaGeoMedianDefense,
    }


class FedMLDefender:
    _instance: Optional["FedMLDefender"] = None

    @classmethod
    def get_instance(cls) -> "FedMLDefender":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self) -> None:
        self.is_enabled = False
        self.defense_type = None
        self.defender = None

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_defense", False))
        if not self.is_enabled:
            self.defense_type, self.defender = None, None
            return
        self.defense_type = str(getattr(args, "defense_type", DEFENSE_KRUM)).strip().lower()
        table = defense_table()
        if self.defense_type not in table:
            raise ValueError(f"unknown defense type {self.defense_type!r}")
        if self.defense_type == DEFENSE_MULTI_KRUM and not hasattr(args, "krum_param_m"):
            args.krum_param_m = max(1, int(getattr(args, "client_num_per_round", 4)) // 2)
        self.defender = table[self.defense_type](args)
        logging.info("defense enabled: %s", self.defense_type)

    def is_defense_enabled(self) -> bool:
        return self.is_enabled and self.defender is not None

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[float, Any]],
                                  extra_auxiliary_info: Any = None):
        return self.defender.defend_before_aggregation(raw_client_grad_list, extra_auxiliary_info)

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[float, Any]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None):
        return self.defender.defend_on_aggregation(raw_client_grad_list, base_aggregation_func,
                                                   extra_auxiliary_info)

    def defend_after_aggregation(self, global_model):
        return self.defender.defend_after_aggregation(global_model)
