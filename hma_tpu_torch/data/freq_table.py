"""Per-dataset control frequencies (Hz) used to derive frame strides.

Data table mirrored from the reference so on-disk datasets resolve to the
same strides (reference: datasets/encode_openx_dataset.py:51-108; the
reference's duplicate "robomimic" key collapses to one entry here).
Stride = max(freq // natural_hz, 1).
"""

DATA_FREQ_TABLE = {
    "austin_sailor_dataset_converted_externally_to_rlds": 20,
    "stanford_hydra_dataset_converted_externally_to_rlds": 10,
    "austin_buds_dataset_converted_externally_to_rlds": 20,
    "austin_sirius_dataset_converted_externally_to_rlds": 20,
    "berkeley_mvp_converted_externally_to_rlds": 5,
    "berkeley_rpt_converted_externally_to_rlds": 30,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": 2,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": 20,
    "utaustin_mutex": 20,
    "imperialcollege_sawyer_wrist_cam": 10,
    "language_table": 2,
    "kuka": 2,
    "bc_z": 10,
    "robo_net": 1,
    "dlr_sara_pour_converted_externally_to_rlds": 10,
    "stanford_robocook_converted_externally_to_rlds": 5,
    "cmu_play_fusion": 5,
    "bridge": 5,
    "furniture_bench_dataset_converted_externally_to_rlds": 10,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": 3,
    "usc_cloth_sim_converted_externally_to_rlds": 10,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": 20,
    "roboturk": 10,
    "kaist_nonprehensile_converted_externally_to_rlds": 10,
    "asu_table_top_converted_externally_to_rlds": 12,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": 10,
    "berkeley_cable_routing": 10,
    "droid": 15,
    "uiuc_d3field": 1,
    "robo_set": 5,
    "toto": 30,
    "nyu_door_opening_surprising_effectiveness": 3,
    "nyu_franka_play_dataset_converted_externally_to_rlds": 3,
    "mimic_play": 15,
    "maniskill_dataset_converted_externally_to_rlds": 20,
    "columbia_cairlab_pusht_real": 10,
    "conq_hose_manipulation": 30,
    "dlr_edan_shared_control_converted_externally_to_rlds": 5,
    "berkeley_gnm_sac_son": 10,
    "berkeley_autolab_ur5": 5,
    "aloha_mobile": 30,
    "1x_humanoid": 30,
    "epic_kitchen_originalres": 30,
    "epic_kitchen": 30,
    "exoego4d": 30,
    "ego4d": 1,
    "robomimic": 6,
    "metaworld": 6,
    "frodobot": 30,
    "fractal20220817_data": 3,
    "robomimic_new": 6,
    "robomimic_multitask_new": 6,
    "robomimic_new_perturb": 6,
    "robomimic_multitask_new_perturb": 6,
}

# Validation split sizing (reference: encode_openx_dataset.py:46-48)
VAL_RATIO = 0.05
MIN_VAL_EXAMPLES, MAX_VAL_EXAMPLES = 20, 200
