"""Det-pretrain dataset mix (reference: groma/data/configs/det_pretrain.py).
Point ann_file/img_prefix at your local copies."""
datasets = [
    dict(type='coco_box', ann_file='coco_instances_train2017.json',
         img_prefix='dataset/coco/train2017'),
    dict(type='obj365_box', ann_file='obj365v2_train_new.json',
         img_prefix='dataset/Objects365V2/images'),
    dict(type='openimage_box', ann_file='openimages_v6_train_bbox.json',
         img_prefix='dataset/openimages/detection'),
    dict(type='v3det_box', ann_file='v3det_2023_v1_train.json',
         img_prefix='dataset/v3det/V3Det'),
    dict(type='sa1b_box', ann_file='sa1b_2m.json',
         img_prefix='dataset/SA1B/images'),
]
