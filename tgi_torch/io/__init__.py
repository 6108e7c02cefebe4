from tgi_torch.io.pickle_import import (load_network_pkl, captured_state_dict,
                                        convert_generator_params,
                                        generator_config_from_captured)
from tgi_torch.io.checkpoints import save_checkpoint, load_checkpoint
from tgi_torch.io.legacy_tf import (ConvertedSG2, convert_tf_generator,
                                    convert_tf_discriminator)
