from .balanced_loss import (Prob_Balanced_Normalized_Loss,
                            Prob_Balanced_Ratio_Loss, Unhappy_Ratio)
from .link_sign_loss import (Link_Sign_Entropy_Loss, Link_Sign_Product_Loss,
                             Sign_Direction_Loss, Sign_Product_Entropy_Loss,
                             Sign_Structure_Loss, Sign_Triangle_Loss,
                             link_sign_product_loss,
                             sign_product_entropy_loss, sign_structure_loss)
from .sampling import negative_sampling, structured_negative_sampling

__all__ = ["Link_Sign_Entropy_Loss", "Link_Sign_Product_Loss",
           "Prob_Balanced_Normalized_Loss", "Prob_Balanced_Ratio_Loss",
           "Sign_Direction_Loss", "Sign_Product_Entropy_Loss",
           "Sign_Structure_Loss", "Sign_Triangle_Loss", "Unhappy_Ratio",
           "link_sign_product_loss", "negative_sampling",
           "sign_product_entropy_loss", "sign_structure_loss",
           "structured_negative_sampling"]
